"""First-order Z4: dynamic-spacetime general relativity (vacuum).

The GR family so far (``grhd``/``grmhd``/``*_cfc``) evolves matter on a
FROZEN metric (the Cowling approximation).  This module adds the missing
rung — evolving the spacetime itself — the capability the downstream
ExaHyPE astrophysics programme (ExaGRyPE) is built around: a first-order
reformulation of the Einstein equations solved as a fluxless
non-conservative hyperbolic system by ADER-DG (reference-family parity:
the reference repo bundles only Euler physics,
``Unit test/Functions.cpp:9-62``; the downstream family's flagship system
is first-order CCZ4 run exactly this way — pure NCP + algebraic source).

The system is the Z4 formulation (the covariant parent of CCZ4: Einstein's
equations with the algebraic constraints embedded in a four-vector
Z_μ = (Θ, Z_i) that propagates and — with the κ₁/κ₂ terms — damps
constraint violations), in vacuum, with zero shift and Bona–Masso slicing

    ∂_t α = −α² g(α) (K − m Θ),   g = f (harmonic) or 2/α (1+log).

First-order reduction variables (38 in 3-D tensor algebra; the grid may
still be 2-D — fields constant along the absent axis):

    α (1), γ_ij (6), K_ij (6), Θ (1), Z_i (3),
    A_k = ∂_k ln α (3),  D_kij = ½ ∂_k γ_ij (18).

Design: ONE tensor-algebra function :func:`z4_rhs` computes the complete
right-hand side from the state and its spatial derivatives using
``einsum`` over honest (i, j, k) tensor indices — no per-component
expansion.  Because every PDE right-hand side is AFFINE in the first
derivatives, the solver's split follows exactly by linearity:

    source(Q)        = z4_rhs(Q, 0)
    B_d(Q)·∂_d Q     = z4_rhs(Q, 0) − z4_rhs(Q, ∂_d Q only)

so the NCP/source pair fed to :class:`~exahype_jax.models.aderdg.
ADERDGSolver` (``ncp_fn``/``source_fn``, the SWE pattern) shares a single
source of truth.  ``tests/test_z4.py`` verifies that truth against a
fully independent oracle: analytic metric fields differentiated with
nested ``jax.jacfwd`` (Ricci from autodiff Christoffels, no D variables
anywhere), plus the standard Apples-with-Apples anchors (flat-space
stationarity, gauge-wave convergence at the scheme order, robust
stability) and ADM constraint monitoring.

Equations (vacuum, zero shift; Alic et al. 2012's Z4 damping scheme):

    ∂_t γ_ij = −2 α K_ij
    ∂_t K_ij = −∇_i∇_j α + α [R_ij + ∇_i Z_j + ∇_j Z_i − 2 K_ik K^k_j
               + (K − 2Θ) K_ij] − κ₁(1+κ₂) α γ_ij Θ
    ∂_t Θ    = α/2 [R + 2∇_k Z^k + (K − 2Θ)K − K_ij K^ij]
               − Z^k ∂_k α − κ₁(2+κ₂) α Θ
    ∂_t Z_i  = α [∇_j (K_i^j − δ_i^j K) + ∂_i Θ − 2 K_i^j Z_j]
               − Θ ∂_i α − κ₁ α Z_i
    ∂_t A_k  = −∂_k [α g (K − m Θ)]
    ∂_t D_kij= −∂_k (α K_ij)

with every metric/lapse derivative written through the evolved D/A
(∂_k γ_ij → 2 D_kij, ∂_k α → α A_k, ∂_k γ^ab → −2 γ^ac γ^bd D_kcd).

A SHIFTED variant (:func:`z4_shift_system`, 53 variables) adds the full
gauge sector β^i, b^i, B_k^i = ∂_k β^i: Lie-derivative terms on the
primary variables, ∂_k-differentiated gauge terms on the reductions,
and either a frozen shift or the hyperbolic Gamma-driver
∂_t β = f_b·b, ∂_t b = ∂_t Γ^i − η·b (Γ^i = γ^jk Γ^i_jk, its time
derivative taken exactly by the chain rule).  Anchored on the exact
moving-coordinates gauge wave (constant β^x = v, wave speed 1−v).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: Every einsum of state at HIGHEST precision (see models/aderdg.py).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

#: Packed symmetric-pair order for 3×3 symmetric tensors.
SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))

N_VARS = 38

# Variable slots.
_AL = 0
_G = slice(1, 7)
_K = slice(7, 13)
_TH = 13
_Z = slice(14, 17)
_A = slice(17, 20)
_D = slice(20, 38)


def sym_to_mat(s):
    """[..., 6] packed symmetric → [..., 3, 3]."""
    rows = [[None] * 3 for _ in range(3)]
    for slot, (i, j) in enumerate(SYM6):
        rows[i][j] = s[..., slot]
        rows[j][i] = s[..., slot]
    return jnp.stack(
        [jnp.stack(r, axis=-1) for r in rows], axis=-2
    )


def mat_to_sym(m):
    """[..., 3, 3] (symmetrized) → [..., 6] packed."""
    m = 0.5 * (m + jnp.swapaxes(m, -1, -2))
    return jnp.stack([m[..., i, j] for (i, j) in SYM6], axis=-1)


def inv3(m):
    """Closed-form batched 3×3 inverse: (inverse, det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca = e * i - f * h
    cb = f * g - d * i
    cc = d * h - e * g
    det = a * ca + b * cb + c * cc
    adj = jnp.stack(
        [
            jnp.stack([ca, c * h - b * i, b * f - c * e], axis=-1),
            jnp.stack([cb, a * i - c * g, c * d - a * f], axis=-1),
            jnp.stack([cc, b * g - a * h, a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None], det


def unpack(q):
    """q[..., 38] → (α, γ[3,3], K[3,3], Θ, Z[3], A[3], D[3,3,3])."""
    al = q[..., _AL]
    g = sym_to_mat(q[..., _G])
    K = sym_to_mat(q[..., _K])
    th = q[..., _TH]
    Z = q[..., _Z]
    A = q[..., _A]
    D = sym_to_mat(q[..., _D].reshape(q.shape[:-1] + (3, 6)))
    return al, g, K, th, Z, A, D


def pack(al, g, K, th, Z, A, D):
    """Inverse of :func:`unpack` (tensor args symmetrized)."""
    Ds = mat_to_sym(D).reshape(D.shape[:-3] + (18,))
    return jnp.concatenate(
        [
            al[..., None],
            mat_to_sym(g),
            mat_to_sym(K),
            th[..., None],
            Z,
            A,
            Ds,
        ],
        axis=-1,
    )


def _slicing(slicing: str, f: float):
    """(g(α), d(αg)/dα) as callables of α."""
    if slicing == "harmonic":
        return (lambda al: jnp.full_like(al, f)), (
            lambda al: jnp.full_like(al, f)
        )
    if slicing == "1+log":
        # αg = 2 exactly, so d(αg)/dα = 0.
        return (lambda al: 2.0 / al), (lambda al: jnp.zeros_like(al))
    raise ValueError(f"unknown slicing {slicing!r}")


def _z4_core(al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD, *,
             slicing, f, m, kappa1, kappa2):
    """Zero-shift Z4 right-hand-side parts (unpacked tensors in, tensor
    parts out) — shared by :func:`z4_rhs` and the shifted system, which
    adds the Lie-derivative/gauge terms on top."""
    gi, _ = inv3(g)
    # ∂_k γ^lm = −2 γ^la γ^mb D_kab
    dgi = -2.0 * _einsum("...la,...mb,...kab->...klm", gi, gi, D)

    # Christoffels from D: Γ_lij = D_ijl + D_jil − D_lij; Γ^k_ij = γ^kl Γ_lij
    Glow = (
        _einsum("...ijl->...lij", D)
        + _einsum("...jil->...lij", D)
        - D
    )
    Gam = _einsum("...kl,...lij->...kij", gi, Glow)
    # Γ^k_kj = γ^kl D_jkl  (= ∂_j ln √γ)
    Gtr = _einsum("...kl,...jkl->...j", gi, D)

    # Ricci: R_ij = ∂_kΓ^k_ij − ∂_iΓ^k_kj + Γ^k_kl Γ^l_ij − Γ^k_li Γ^l_kj
    dGlow = (
        _einsum("...kijl->...klij", dD)
        + _einsum("...kjil->...klij", dD)
        - dD
    )
    ric = (
        _einsum("...kkl,...lij->...ij", dgi, Glow)
        + _einsum("...kl,...klij->...ij", gi, dGlow)
        - _einsum("...ikl,...jkl->...ij", dgi, D)
        - _einsum("...kl,...ijkl->...ij", gi, dD)
        + _einsum("...l,...lij->...ij", Gtr, Gam)
        - _einsum("...kli,...lkj->...ij", Gam, Gam)
    )
    ric = 0.5 * (ric + jnp.swapaxes(ric, -1, -2))

    # ∇_i∇_j α / α  (∂α = αA substituted; dA symmetrized)
    hess = (
        0.5 * (dA + jnp.swapaxes(dA, -1, -2))
        + _einsum("...i,...j->...ij", A, A)
        - _einsum("...kij,...k->...ij", Gam, A)
    )
    covZ = dZ - _einsum("...kij,...k->...ij", Gam, Z)

    trK = _einsum("...ij,...ij->...", gi, K)
    Kup = _einsum("...ia,...jb,...ab->...ij", gi, gi, K)
    K2 = _einsum("...ij,...ij->...", K, Kup)
    KK = _einsum("...il,...lm,...mj->...ij", K, gi, K)
    Kmix = _einsum("...jl,...il->...ij", gi, K)  # K_i^j
    # ∇_j K_i^j = γ^jl (∂_j K_il − Γ^m_ji K_ml − Γ^m_jl K_im)
    divKi = (
        _einsum("...jl,...jil->...i", gi, dK)
        - _einsum("...jl,...mji,...ml->...i", gi, Gam, K)
        - _einsum("...jl,...mjl,...im->...i", gi, Gam, K)
    )
    # ∂_i (tr K) = (∂_i γ^kl) K_kl + γ^kl ∂_i K_kl
    dtrK = _einsum("...ikl,...kl->...i", dgi, K) + _einsum(
        "...kl,...ikl->...i", gi, dK
    )
    Rs = _einsum("...ij,...ij->...", gi, ric)
    divZ = _einsum("...ij,...ij->...", gi, covZ)
    Zup = _einsum("...ij,...j->...i", gi, Z)

    g_of, dag_of = _slicing(slicing, f)
    gal = g_of(al)
    ag = al * gal
    dag = dag_of(al)
    Kmth = trK - m * th

    alx = al[..., None]
    alxx = al[..., None, None]
    r_al = -ag * al * Kmth
    r_g = -2.0 * alxx * K
    r_K = (
        -alxx * hess
        + alxx
        * (
            ric
            + covZ
            + jnp.swapaxes(covZ, -1, -2)
            - 2.0 * KK
            + (trK - 2.0 * th)[..., None, None] * K
        )
        - kappa1 * (1.0 + kappa2) * alxx * th[..., None, None] * g
    )
    r_th = (
        0.5 * al * (Rs + 2.0 * divZ + (trK - 2.0 * th) * trK - K2)
        - al * _einsum("...i,...i->...", Zup, A)
        - kappa1 * (2.0 + kappa2) * al * th
    )
    r_Z = (
        alx
        * (divKi - dtrK + dth - 2.0 * _einsum("...ij,...j->...i", Kmix, Z))
        - alx * th[..., None] * A
        - kappa1 * alx * Z
    )
    r_A = -dag[..., None] * al[..., None] * A * Kmth[..., None] - ag[
        ..., None
    ] * (dtrK - m * dth)
    r_D = (
        -alxx[..., None] * _einsum("...k,...ij->...kij", A, K)
        - al[..., None, None, None] * dK
    )
    return r_al, r_g, r_K, r_th, r_Z, r_A, r_D


def z4_rhs(
    q,
    dq3,
    *,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
):
    """The COMPLETE vacuum Z4 right-hand side ∂_t Q (zero shift).

    ``q``: state [..., 38]; ``dq3``: spatial derivatives [..., 3, 38]
    (∂_k Q for k = x, y, z; zero-fill the axes a lower-dimensional grid
    does not have).  Affine in ``dq3`` — the solver NCP/source split in
    :func:`z4_system` relies on that.
    """
    al, g, K, th, Z, A, D = unpack(q)
    dK = sym_to_mat(dq3[..., _K])  # [..., k, 3, 3] = ∂_k K_ij
    dth = dq3[..., _TH]  # [..., k]
    dZ = dq3[..., _Z]  # [..., k, i] = ∂_k Z_i
    dA = dq3[..., _A]  # [..., k, i] = ∂_k A_i
    dD = sym_to_mat(
        dq3[..., _D].reshape(dq3.shape[:-1] + (3, 6))
    )  # [..., k, l, 3, 3] = ∂_k D_lij
    parts = _z4_core(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )
    return pack(*parts)


# ------------------------------------------------------------- shift sector
#
# The shifted system extends the 38-variable state with the full gauge
# sector: β^i (3), the Gamma-driver auxiliary b^i (3), and the first-order
# reduction B_k^i = ∂_k β^i (9) — 53 variables.  The evolution equations
# are the zero-shift ones plus Lie-derivative terms (∂_t − L_β is the
# tensorial derivative on the slice) for the primary variables, and the
# ∂_k-differentiated gauge/Lie terms for the reductions A_k and D_kij.

N_VARS_SHIFT = 53

_BETA = slice(38, 41)
_BSM = slice(41, 44)
_BB = slice(44, 53)  # B_k^i at 44 + 3k + i


def unpack_shift(q):
    """q[..., 53] → (β[i], b[i], B[k, i])."""
    beta = q[..., _BETA]
    b = q[..., _BSM]
    B = q[..., _BB].reshape(q.shape[:-1] + (3, 3))
    return beta, b, B


def pack_shift(core_parts, r_beta, r_b, r_B):
    base = pack(*core_parts)
    return jnp.concatenate(
        [base, r_beta, r_b, r_B.reshape(r_B.shape[:-2] + (9,))], axis=-1
    )


def _gamma_contracted(g, D):
    """Γ^i = γ^jk Γ^i_jk as an algebraic function of (γ, D) — the quantity
    the Gamma-driver shift chases (the non-conformal analogue of Γ̃^i)."""
    gi, _ = inv3(g)
    Glow = (
        _einsum("...ijl->...lij", D)
        + _einsum("...jil->...lij", D)
        - D
    )
    return _einsum("...il,...jk,...ljk->...i", gi, gi, Glow)


def z4_shift_rhs(
    q,
    dq3,
    *,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
):
    """Vacuum Z4 right-hand side WITH a shift vector (53 variables).

    Primary variables gain Lie-derivative terms (∂_t = zero-shift RHS
    + L_β X); the reductions A_k, D_kij gain ∂_k of the β-terms in the
    primary equations (B_k^i = ∂_k β^i is evolved, so second derivatives
    of β appear only as first derivatives of B).  Shift evolution:

    - ``shift='frozen'``: ∂_t β = ∂_t b = 0 (prescribed static shift —
      the moving-coordinates testbeds).
    - ``shift='gamma_driver'``: ∂_t β^i = f_b·b^i,
      ∂_t b^i = ∂_t Γ^i − η·b^i, with Γ^i = γ^jk Γ^i_jk algebraic in
      (γ, D) so ∂_t Γ^i follows EXACTLY by the chain rule (``jax.jvp``
      of :func:`_gamma_contracted` along (∂_t γ, ∂_t D)) — the
      hyperbolic driver on the non-conformal contracted Christoffel.

    Affine in ``dq3`` (the jvp is linear in the already-affine ∂_t γ,
    ∂_t D), so the NCP/source split still follows by linearity.
    """
    al, g, K, th, Z, A, D = unpack(q)
    beta, b, B = unpack_shift(q)
    dK = sym_to_mat(dq3[..., _K])
    dth = dq3[..., _TH]
    dZ = dq3[..., _Z]
    dA = dq3[..., _A]
    dD = sym_to_mat(dq3[..., _D].reshape(dq3.shape[:-1] + (3, 6)))
    dB = dq3[..., _BB].reshape(dq3.shape[:-1] + (3, 3))  # [k, l, i] = ∂_k B_l^i

    r_al, r_g, r_K, r_th, r_Z, r_A, r_D = _z4_core(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )

    # Primary Lie-derivative terms.
    r_al = r_al + al * _einsum("...k,...k->...", beta, A)
    lie_g = (
        2.0 * _einsum("...k,...kij->...ij", beta, D)
        + _einsum("...ik,...kj->...ij", B, g)
        + _einsum("...jk,...ki->...ij", B, g)
    )
    r_g = r_g + lie_g
    r_K = (
        r_K
        + _einsum("...k,...kij->...ij", beta, dK)
        + _einsum("...ik,...kj->...ij", B, K)
        + _einsum("...jk,...ki->...ij", B, K)
    )
    r_th = r_th + _einsum("...k,...k->...", beta, dth)
    r_Z = (
        r_Z
        + _einsum("...k,...ki->...i", beta, dZ)
        + _einsum("...ik,...k->...i", B, Z)
    )
    # Reductions: ∂_k of the β-terms in ∂_t lnα and ∂_t γ_ij.
    #   ∂_t A_k += ∂_k(β^m A_m) = B_k^m A_m + β^m ∂_k A_m
    r_A = (
        r_A
        + _einsum("...km,...m->...k", B, A)
        + _einsum("...m,...km->...k", beta, dA)
    )
    #   ∂_t D_kij += B_k^m D_mij + β^m ∂_k D_mij
    #              + D_kmj B_i^m + D_kim B_j^m
    #              + ½(γ_mj ∂_k B_i^m + γ_im ∂_k B_j^m)
    r_D = (
        r_D
        + _einsum("...km,...mij->...kij", B, D)
        + _einsum("...m,...kmij->...kij", beta, dD)
        + _einsum("...im,...kmj->...kij", B, D)
        + _einsum("...jm,...kmi->...kij", B, D)
        + 0.5 * _einsum("...kim,...mj->...kij", dB, g)
        + 0.5 * _einsum("...kjm,...mi->...kij", dB, g)
    )

    if shift == "frozen":
        r_beta = jnp.zeros_like(beta)
        r_b = jnp.zeros_like(b)
        r_B = jnp.zeros_like(B)
    elif shift == "gamma_driver":
        r_beta = f_b * b
        # ∂_t Γ^i by the chain rule along the full (∂_t γ, ∂_t D).
        _, dt_gamma = jax.jvp(
            lambda gg, DD: _gamma_contracted(gg, DD), (g, D), (r_g, r_D)
        )
        r_b = dt_gamma - eta * b
        # ∂_t B_k^i = ∂_k(∂_t β^i) = f_b ∂_k b^i — but b has no evolved
        # reduction; close with the driver's own spatial derivative from
        # dq3 (b IS an evolved variable, so ∂_k b is available).
        db = dq3[..., _BSM]  # [..., k, i] = ∂_k b^i
        r_B = f_b * db
    else:
        raise ValueError(f"unknown shift mode {shift!r}")
    return pack_shift((r_al, r_g, r_K, r_th, r_Z, r_A, r_D), r_beta, r_b, r_B)


def z4_shift_system(
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
    impl: str = "einsum",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) for the 53-variable
    shifted Z4 system.  The Rusanov bound adds the coordinate advection
    speed |β^d| to the wider of the light/gauge cones.

    ``impl='soa'`` routes ncp/source through :func:`z4_shift_rhs_soa`
    (see :func:`z4_system`)."""
    kw = dict(
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
        shift=shift, f_b=f_b, eta=eta,
    )
    g_of, _ = _slicing(slicing, f)
    shift_rhs_impl = z4_shift_rhs_soa if impl == "soa" else z4_shift_rhs

    def flux(Q, axis, va):
        return jnp.zeros_like(Q)

    def eig(Q, axis, va):
        q = jnp.moveaxis(Q, va, -1)
        al = q[..., _AL]
        gi, _ = inv3(sym_to_mat(q[..., _G]))
        gdd = gi[..., axis, axis]
        bd = jnp.abs(q[..., 38 + axis])
        return bd + al * jnp.sqrt(jnp.maximum(g_of(al), 1.0) * gdd)

    def _rhs(q, dq3):
        return shift_rhs_impl(q, dq3, **kw)

    def source(Q, va):
        q = jnp.moveaxis(Q, va, -1)
        dq3 = jnp.zeros(q.shape[:-1] + (3, N_VARS_SHIFT), q.dtype)
        return jnp.moveaxis(_rhs(q, dq3), -1, va)

    def ncp(Q, dQ, axis, va):
        q = jnp.moveaxis(Q, va, -1)
        dq = jnp.moveaxis(dQ, va, -1)
        zeros = jnp.zeros(q.shape[:-1] + (3, N_VARS_SHIFT), q.dtype)
        zrow = jnp.zeros_like(dq)
        dq3 = jnp.stack(
            [dq if d == axis else zrow for d in range(3)], axis=-2
        )
        out = _rhs(q, zeros) - _rhs(q, dq3)
        return jnp.moveaxis(out, -1, va)

    return flux, eig, ncp, source


def make_z4_shift_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
    fused_rhs=False,
    impl: str = "einsum",
    **kwargs,
):
    """A fully-configured SHIFTED vacuum Z4 ADER-DG solver (periodic).
    ``fused_rhs`` / ``impl``: see :func:`make_z4_solver`."""
    from exahype_jax.models.aderdg import ADERDGSolver

    kw = dict(
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
        shift=shift, f_b=f_b, eta=eta,
    )
    flux, eig, ncp, source = z4_shift_system(impl=impl, **kw)
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_shift_rhs_soa(q, dq3, **kw), N_VARS_SHIFT,
        )
    elif fused_rhs:
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_shift_rhs(q, dq3, **kw), N_VARS_SHIFT
        )
    else:
        rhs_all = None
    return ADERDGSolver(
        dim=dim,
        order=order,
        n_vars=N_VARS_SHIFT,
        grid_shape=grid_shape,
        flux_fn=flux,
        max_eigenvalue_fn=eig,
        ncp_fn=ncp,
        source_fn=source,
        rhs_all_fn=rhs_all,
        dx=dx,
        **kwargs,
    )


def moving_gauge_wave_values(x, t, v=0.2, amplitude=0.01, wavelength=1.0):
    """The gauge wave in uniformly-moving coordinates x' = x − v·t: an
    exact vacuum solution with CONSTANT shift β^x = v that exercises every
    shift/Lie term.  From ds² = −H dt² + H dx² (H = 1 − a·sin(2π(x−t)/L))
    substitute dx = dx' + v dt:

        γ_x'x' = H,  α = √H,  β^{x'} = v,  K_x'x' = ∂_{x'}H/(2√H),

    with H now a function of ξ = x' − (1−v)t — the wave translates at
    coordinate speed (1−v).  The 3+1 identity K = −(∂_t γ − L_β γ)/(2α)
    and the harmonic slicing condition both hold exactly (checked in
    tests).  B = b = 0 since β is constant."""
    x = np.asarray(x, dtype=np.float64)
    k = 2.0 * np.pi / wavelength
    s = np.sin(k * (x - (1.0 - v) * t))
    c = np.cos(k * (x - (1.0 - v) * t))
    H = 1.0 - amplitude * s
    dH = -amplitude * k * c  # ∂_x H
    al = np.sqrt(H)
    out = np.zeros(x.shape + (N_VARS_SHIFT,))
    out[..., 0] = al
    out[..., 1] = H
    out[..., 4] = 1.0
    out[..., 6] = 1.0
    out[..., 7] = dH / (2.0 * al)
    out[..., 17] = dH / (2.0 * H)
    out[..., 20] = 0.5 * dH
    out[..., 38] = v
    return out


def moving_gauge_wave_state(solver, t=0.0, v=0.2, amplitude=0.01,
                            wavelength=None):
    """Exact moving-coordinates gauge-wave nodal state (wave along grid
    axis 0; default wavelength = the axis-0 domain length)."""
    coords = solver.nodes_meshgrid()
    if wavelength is None:
        wavelength = solver.grid_shape[0] * solver._dxs[0]
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), axis=solver.var_axis),
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :],
    )
    vals = moving_gauge_wave_values(x, t, v, amplitude, wavelength)
    return jnp.asarray(np.moveaxis(vals, -1, solver.var_axis))


def z4_system(
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    impl: str = "einsum",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) in the solver's
    ``(Q, axis, var_axis)`` contract — a fluxless pure-NCP system, the
    shape the downstream family's FO-CCZ4 application uses.

    The characteristic cones are the light cone (speed α√γ^dd along axis
    d) and the gauge cone (α√(g γ^dd)); the Rusanov bound takes the wider.

    ``impl='soa'`` routes ncp/source through the component-unrolled twin
    :func:`z4_rhs_soa` (identical algebra to rounding — tested; pure
    elementwise ops: the per-axis calls see literal-zero derivative blocks
    that XLA folds through the unrolled algebra).
    """
    kw = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2)
    g_of, _ = _slicing(slicing, f)

    def flux(Q, axis, va):
        return jnp.zeros_like(Q)

    def eig(Q, axis, va):
        q = jnp.moveaxis(Q, va, -1)
        al = q[..., _AL]
        gi, _ = inv3(sym_to_mat(q[..., _G]))
        gdd = gi[..., axis, axis]
        return al * jnp.sqrt(jnp.maximum(g_of(al), 1.0) * gdd)

    rhs_impl = z4_rhs_soa if impl == "soa" else z4_rhs

    def _rhs(q, dq3):
        return rhs_impl(q, dq3, **kw)

    def source(Q, va):
        q = jnp.moveaxis(Q, va, -1)
        dq3 = jnp.zeros(q.shape[:-1] + (3, N_VARS), q.dtype)
        return jnp.moveaxis(_rhs(q, dq3), -1, va)

    def ncp(Q, dQ, axis, va):
        # rhs is affine in the derivatives: B_d·∂_dQ = rhs(Q,0) − rhs(Q,∂_d)
        q = jnp.moveaxis(Q, va, -1)
        dq = jnp.moveaxis(dQ, va, -1)
        zeros = jnp.zeros(q.shape[:-1] + (3, N_VARS), q.dtype)
        # stack (not .at[].set, which lowers to a scatter)
        zrow = jnp.zeros_like(dq)
        dq3 = jnp.stack(
            [dq if d == axis else zrow for d in range(3)], axis=-2
        )
        out = _rhs(q, zeros) - _rhs(q, dq3)
        return jnp.moveaxis(out, -1, va)

    return flux, eig, ncp, source


def _rhs_all_of(rhs_fn, n_vars):
    """Wrap an affine ``rhs(q, dq3)`` as the solver's fused
    ``rhs_all_fn(Q, grads, va)`` hook: by affinity the single full-RHS
    evaluation equals ``source − Σ_d B_d·∂_d Q`` exactly, replacing the
    2·dim+1 per-axis evaluations in the Picard predictor."""

    def rhs_all(Q, grads, va):
        q = jnp.moveaxis(Q, va, -1)
        rows = [jnp.moveaxis(gq, va, -1) for gq in grads]
        rows += [jnp.zeros_like(rows[0])] * (3 - len(rows))
        dq3 = jnp.stack(rows, axis=-2)
        return jnp.moveaxis(rhs_fn(q, dq3), -1, va)

    return rhs_all


def flat_state_values() -> np.ndarray:
    """Minkowski in Cartesian coordinates (the robust-stability base)."""
    v = np.zeros(N_VARS)
    v[_AL] = 1.0
    v[1] = v[4] = v[6] = 1.0  # γ = identity (xx, yy, zz slots)
    return v


def z4_flat_state(solver) -> jnp.ndarray:
    """Flat-space nodal state broadcast to ``solver.state_shape``."""
    v = flat_state_values()
    shape = [1] * len(solver.state_shape)
    shape[solver.var_axis] = N_VARS
    return jnp.asarray(
        np.broadcast_to(v.reshape(shape), solver.state_shape).copy()
    )


def gauge_wave_values(x, t, amplitude=0.01, wavelength=1.0):
    """The Apples-with-Apples gauge wave, var-last values at positions x.

    ds² = −H dt² + H dx² + dy² + dz², H = 1 − a sin(2π(x−t)/L): flat
    spacetime in a wavelike harmonic gauge — the canonical exact solution
    for dynamic-GR evolution codes (harmonic slicing f=1, zero shift,
    Θ = Z = 0).  Every first-order variable is exact-analytic here.
    """
    x = np.asarray(x, dtype=np.float64)
    k = 2.0 * np.pi / wavelength
    s = np.sin(k * (x - t))
    c = np.cos(k * (x - t))
    H = 1.0 - amplitude * s
    dH = -amplitude * k * c  # ∂_x H  (= −∂_t H)
    al = np.sqrt(H)
    out = np.zeros(x.shape + (N_VARS,))
    out[..., _AL] = al
    out[..., 1] = H  # γ_xx
    out[..., 4] = 1.0  # γ_yy
    out[..., 6] = 1.0  # γ_zz
    # K_xx = −∂_t γ_xx / (2α) = −(−dH)/(2√H) ... ∂_t H = −∂_x H·(−1)?  With
    # H(x−t): ∂_t H = −dH·(−1)?  d/dt sin(k(x−t)) = −k c ⇒ ∂_t H = +a k c
    # = −dH.  K_xx = −∂_tγ_xx/(2α) = dH/(2√H).
    out[..., 7] = dH / (2.0 * al)
    out[..., 17] = dH / (2.0 * H)  # A_x = ∂_x ln α = ∂_x H/(2H)
    out[..., 20] = 0.5 * dH  # D_xxx = ½ ∂_x γ_xx
    return out


def gauge_wave_state(solver, t=0.0, amplitude=0.01, wavelength=None):
    """Exact gauge-wave nodal state on ``solver`` (wave along grid axis 0;
    default wavelength = the axis-0 domain length, so the state is
    periodic)."""
    coords = solver.nodes_meshgrid()
    if wavelength is None:
        wavelength = solver.grid_shape[0] * solver._dxs[0]
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), axis=solver.var_axis),
        solver.state_shape[: solver.var_axis]
        + solver.state_shape[solver.var_axis + 1 :],
    )
    vals = gauge_wave_values(x, t, amplitude, wavelength)
    return jnp.asarray(np.moveaxis(vals, -1, solver.var_axis))


def make_z4_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    fused_rhs=False,
    impl: str = "einsum",
    **kwargs,
):
    """A fully-configured vacuum Z4 ADER-DG solver (periodic box).

    Performance knobs (identical algebra to rounding — parity-tested;
    their speed on the GPU is not measured yet):

    - ``impl``: ``"einsum"`` (default, the validated-oracle layout) or
      ``"soa"`` — component-unrolled ncp/source callbacks: the per-axis
      NCP calls hand the unrolled algebra literal-zero derivative blocks
      that XLA folds away, and the surviving arithmetic is pure
      elementwise over the grid.
    - ``fused_rhs``: ``False`` (default) per-axis NCP; ``True`` installs
      the one-evaluation einsum ``rhs_all_fn`` hook; ``"soa"`` the
      component-unrolled hook (materializing the full ``[..., 3, 38]``
      derivative tensor denies the zero-block folding)."""
    from exahype_jax.models.aderdg import ADERDGSolver

    kw = dict(slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2)
    flux, eig, ncp, source = z4_system(impl=impl, **kw)
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_rhs_soa(q, dq3, **kw), N_VARS,
        )
    elif fused_rhs:
        rhs_all = _rhs_all_of(lambda q, dq3: z4_rhs(q, dq3, **kw), N_VARS)
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


def adm_constraints(q, dq3):
    """Vacuum ADM constraints from the first-order state (var-last).

    Returns ``(H, M)``: the Hamiltonian constraint
    ``H = R + K² − K_ij K^ij`` (scalar) and the momentum constraint
    ``M_i = ∇_j K^j_i − ∂_i K`` — both identically zero on a solution of
    Einstein's equations, so their magnitude is the standard evolution-
    quality monitor.  ``dq3`` as in :func:`z4_rhs`.
    """
    al, g, K, th, Z, A, D = unpack(q)
    dK = sym_to_mat(dq3[..., _K])
    dD = sym_to_mat(dq3[..., _D].reshape(dq3.shape[:-1] + (3, 6)))
    gi, _ = inv3(g)
    dgi = -2.0 * _einsum("...la,...mb,...kab->...klm", gi, gi, D)
    Glow = (
        _einsum("...ijl->...lij", D)
        + _einsum("...jil->...lij", D)
        - D
    )
    Gam = _einsum("...kl,...lij->...kij", gi, Glow)
    Gtr = _einsum("...kl,...jkl->...j", gi, D)
    dGlow = (
        _einsum("...kijl->...klij", dD)
        + _einsum("...kjil->...klij", dD)
        - dD
    )
    ric = (
        _einsum("...kkl,...lij->...ij", dgi, Glow)
        + _einsum("...kl,...klij->...ij", gi, dGlow)
        - _einsum("...ikl,...jkl->...ij", dgi, D)
        - _einsum("...kl,...ijkl->...ij", gi, dD)
        + _einsum("...l,...lij->...ij", Gtr, Gam)
        - _einsum("...kli,...lkj->...ij", Gam, Gam)
    )
    ric = 0.5 * (ric + jnp.swapaxes(ric, -1, -2))
    Rs = _einsum("...ij,...ij->...", gi, ric)
    trK = _einsum("...ij,...ij->...", gi, K)
    Kup = _einsum("...ia,...jb,...ab->...ij", gi, gi, K)
    K2 = _einsum("...ij,...ij->...", K, Kup)
    ham = Rs + trK * trK - K2
    divKi = (
        _einsum("...jl,...jil->...i", gi, dK)
        - _einsum("...jl,...mji,...ml->...i", gi, Gam, K)
        - _einsum("...jl,...mjl,...im->...i", gi, Gam, K)
    )
    dtrK = _einsum("...ikl,...kl->...i", dgi, K) + _einsum(
        "...kl,...ikl->...i", gi, dK
    )
    mom = divKi - dtrK
    return ham, mom


def solver_constraints(solver, Q):
    """(H, M_i) on every node of a solver state: nodal spectral
    derivatives per grid axis (exact for the DG polynomial), missing
    3-D axes zero-filled on 2-D grids."""
    q = jnp.moveaxis(Q, solver.var_axis, -1)
    Dmat = jnp.asarray(solver.ops.D, q.dtype)
    parts = []
    for k in range(3):
        if k < solver.dim:
            na = solver.node_axis(k)
            na = na if na < solver.var_axis else na - 1
            d = jnp.tensordot(Dmat, q, axes=([1], [na]))
            d = jnp.moveaxis(d, 0, na) / solver._dxs[k]
        else:
            d = jnp.zeros_like(q)
        parts.append(d)
    dq3 = jnp.stack(parts, axis=-2)
    return adm_constraints(q, dq3)


# ------------------------------------------------- SoA-unrolled evaluation
#
# The einsum formulation above contracts length-3 tensor indices that sit
# innermost in memory.  This twin evaluates the SAME algebra
# component-unrolled: tensors are numpy OBJECT arrays whose entries are
# [grid]-shaped jnp arrays, contractions unroll at trace time into pure
# elementwise arithmetic over the grid — the structure hand-written
# first-order-CCZ4 GPU kernels use.
# Parity with the validated einsum core is tested to rounding.


def _oein(spec, *ops):
    """Tiny trace-time einsum over object ndarrays of jnp grid arrays.

    All indices have extent 3.  Supports an optional '->' (no broadcast
    '...'; scalars come back as bare entries)."""
    from itertools import product as _prod

    spec = spec.replace(" ", "")
    if "->" in spec:
        lhs, out = spec.split("->")
    else:
        lhs = spec
        counts = {}
        for ch in lhs.replace(",", ""):
            counts[ch] = counts.get(ch, 0) + 1
        out = "".join(sorted(ch for ch, n in counts.items() if n == 1))
    ins = lhs.split(",")
    contracted = sorted(
        {ch for sub in ins for ch in sub if ch not in out}
    )
    res = np.empty((3,) * len(out), dtype=object)
    for oa in _prod(range(3), repeat=len(out)):
        env = dict(zip(out, oa))
        acc = None
        for ca in _prod(range(3), repeat=len(contracted)):
            env.update(zip(contracted, ca))
            term = None
            for op, sub in zip(ops, ins):
                v = op[tuple(env[c] for c in sub)]
                term = v if term is None else term * v
            acc = term if acc is None else acc + term
        res[oa] = acc
    return res if out else res[()]


def _omap(fn, *Ts):
    """Elementwise map over object ndarrays (scalar×tensor etc.)."""
    return np.frompyfunc(fn, len(Ts), 1)(*Ts)


def _osym(T):
    """Symmetrize an object (3, 3) array in its two indices."""
    return _omap(lambda a, b: 0.5 * (a + b), T, T.T)


def _oinv3(G):
    """Cofactor inverse of an object (3, 3) array: (inverse, det)."""
    a, b, c = G[0, 0], G[0, 1], G[0, 2]
    d, e, f = G[1, 0], G[1, 1], G[1, 2]
    g_, h, i = G[2, 0], G[2, 1], G[2, 2]
    ca = e * i - f * h
    cb = f * g_ - d * i
    cc = d * h - e * g_
    det = a * ca + b * cb + c * cc
    inv_det = 1.0 / det
    rows = [
        [ca, c * h - b * i, b * f - c * e],
        [cb, a * i - c * g_, c * d - a * f],
        [cc, b * g_ - a * h, a * e - b * d],
    ]
    out = np.empty((3, 3), dtype=object)
    for ii in range(3):
        for jj in range(3):
            out[ii, jj] = rows[ii][jj] * inv_det
    return out, det


def _vsl(q, k):
    """Variable slot ``k`` of a var-last state array."""
    return q[..., k]


def _dsl(dq3, k, slot):
    """Derivative ∂_k of variable ``slot`` (dq3 is ``[..., 3, V]``)."""
    return dq3[..., k, slot]


def _sym_obj(q, sl):
    """Pack a 6-slot symmetric slice of q into an object (3, 3) array."""
    out = np.empty((3, 3), dtype=object)
    base = sl.start
    for slot, (i, j) in enumerate(SYM6):
        out[i, j] = _vsl(q, base + slot)
        out[j, i] = out[i, j]
    return out


def _vec_obj(q, sl):
    out = np.empty((3,), dtype=object)
    for i in range(3):
        out[i] = _vsl(q, sl.start + i)
    return out


def _z4_unpack_soa(q, dq3):
    """Slice a var-last state ``q[..., V]`` and 3-direction derivative
    stack ``dq3[..., 3, V]`` into object-array tensors (entries are
    grid-shaped jnp arrays)."""
    al = _vsl(q, _AL)
    g = _sym_obj(q, _G)
    K = _sym_obj(q, _K)
    th = _vsl(q, _TH)
    Z = _vec_obj(q, _Z)
    A = _vec_obj(q, _A)
    D = np.empty((3, 3, 3), dtype=object)
    dK = np.empty((3, 3, 3), dtype=object)
    dth = np.empty((3,), dtype=object)
    dZ = np.empty((3, 3), dtype=object)
    dA = np.empty((3, 3), dtype=object)
    dD = np.empty((3, 3, 3, 3), dtype=object)
    for k in range(3):
        for slot, (i, j) in enumerate(SYM6):
            D[k, i, j] = D[k, j, i] = _vsl(q, _D.start + 6 * k + slot)
            dK[k, i, j] = dK[k, j, i] = _dsl(dq3, k, _K.start + slot)
        dth[k] = _dsl(dq3, k, _TH)
        for i in range(3):
            dZ[k, i] = _dsl(dq3, k, _Z.start + i)
            dA[k, i] = _dsl(dq3, k, _A.start + i)
        for l in range(3):
            for slot, (i, j) in enumerate(SYM6):
                dD[k, l, i, j] = dD[k, l, j, i] = _dsl(
                    dq3, k, _D.start + 6 * l + slot
                )
    return al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD


def _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D, extra=()):
    """Symmetrize the (i, j) pairs and stack into the packed (last) var
    axis."""
    parts = [r_al]
    r_g = _osym(r_g)
    r_K = _osym(r_K)
    for (i, j) in SYM6:
        parts.append(r_g[i, j])
    for (i, j) in SYM6:
        parts.append(r_K[i, j])
    parts.append(r_th)
    parts.extend(r_Z[i] for i in range(3))
    parts.extend(r_A[i] for i in range(3))
    for k in range(3):
        rDs = _osym(r_D[k])
        for (i, j) in SYM6:
            parts.append(rDs[i, j])
    parts.extend(extra)
    return jnp.stack(parts, axis=-1)


def z4_rhs_soa(
    q,
    dq3,
    *,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
):
    """Component-unrolled twin of :func:`z4_rhs` (identical algebra,
    every operation elementwise over the grid).

    Same contract: ``q`` var-last [..., 38], ``dq3`` [..., 3, 38]."""
    al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD = _z4_unpack_soa(q, dq3)
    parts = _z4_core_soa(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )
    return _z4_pack_soa(*parts)


def _z4_core_soa(al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD, *,
                 slicing, f, m, kappa1, kappa2):
    """Zero-shift Z4 RHS parts on object-array tensors — the SoA twin of
    :func:`_z4_core`.  Returns raw (unsymmetrized) parts."""
    E = _oein
    gi, _ = _oinv3(g)
    dgi = _omap(lambda x: -2.0 * x, E("la,mb,kab->klm", gi, gi, D))
    Glow = (
        np.transpose(D, (2, 0, 1)) + np.transpose(D, (2, 1, 0)) - D
    )
    Gam = E("kl,lij->kij", gi, Glow)
    Gtr = E("kl,jkl->j", gi, D)
    dGlow = (
        np.transpose(dD, (0, 3, 1, 2))
        + np.transpose(dD, (0, 3, 2, 1))
        - dD
    )
    ric = (
        E("kkl,lij->ij", dgi, Glow)
        + E("kl,klij->ij", gi, dGlow)
        - E("ikl,jkl->ij", dgi, D)
        - E("kl,ijkl->ij", gi, dD)
        + E("l,lij->ij", Gtr, Gam)
        - E("kli,lkj->ij", Gam, Gam)
    )
    ric = _osym(ric)

    hess = (
        _osym(dA) + E("i,j->ij", A, A) - E("kij,k->ij", Gam, A)
    )
    covZ = dZ - E("kij,k->ij", Gam, Z)
    trK = E("ij,ij->", gi, K)
    Kup = E("ia,jb,ab->ij", gi, gi, K)
    K2 = E("ij,ij->", K, Kup)
    KK = E("il,lm,mj->ij", K, gi, K)
    Kmix = E("jl,il->ij", gi, K)
    divKi = (
        E("jl,jil->i", gi, dK)
        - E("jl,mji,ml->i", gi, Gam, K)
        - E("jl,mjl,im->i", gi, Gam, K)
    )
    dtrK = E("ikl,kl->i", dgi, K) + E("kl,ikl->i", gi, dK)
    Rs = E("ij,ij->", gi, ric)
    divZ = E("ij,ij->", gi, covZ)
    Zup = E("ij,j->i", gi, Z)

    g_of, dag_of = _slicing(slicing, f)
    gal = g_of(al)
    ag = al * gal
    dag = dag_of(al)
    Kmth = trK - m * th

    r_al = -ag * al * Kmth
    r_g = _omap(lambda x: -2.0 * al * x, K)
    r_K = _omap(
        lambda h, r, cz, czt, kk, kq, gq: (
            -al * h
            + al * (r + cz + czt - 2.0 * kk + (trK - 2.0 * th) * kq)
            - kappa1 * (1.0 + kappa2) * al * th * gq
        ),
        hess, ric, covZ, covZ.T, KK, K, g,
    )
    r_th = (
        0.5 * al * (Rs + 2.0 * divZ + (trK - 2.0 * th) * trK - K2)
        - al * E("i,i->", Zup, A)
        - kappa1 * (2.0 + kappa2) * al * th
    )
    KmixZ = E("ij,j->i", Kmix, Z)
    r_Z = _omap(
        lambda dk, dt, dthi, kz, av, zv: (
            al * (dk - dt + dthi - 2.0 * kz) - al * th * av
            - kappa1 * al * zv
        ),
        divKi, dtrK, dth, KmixZ, A, Z,
    )
    r_A = _omap(
        lambda av, dt, dthk: -dag * al * av * Kmth - ag * (dt - m * dthk),
        A, dtrK, dth,
    )
    r_D = _omap(
        lambda ak, kij, dkv: -al * ak * kij - al * dkv,
        np.broadcast_to(A[:, None, None], (3, 3, 3)),
        np.broadcast_to(K[None, :, :], (3, 3, 3)),
        dK,
    )
    return r_al, r_g, r_K, r_th, r_Z, r_A, r_D


def z4_shift_rhs_soa(
    q,
    dq3,
    *,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    shift: str = "frozen",
    f_b: float = 0.75,
    eta: float = 1.0,
):
    """Component-unrolled twin of :func:`z4_shift_rhs` (53 variables).

    Identical algebra to rounding (tested); the Gamma-driver's exact
    chain-rule ∂_t Γ^i is written out explicitly instead of ``jax.jvp``
    (∂_t γ^ab = −γ^am γ^bn ∂_t γ_mn, ∂_t Γlow by the same permutation
    as Γlow itself — both linear, so the result is the same jvp)."""
    E = _oein
    al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD = _z4_unpack_soa(q, dq3)
    beta = _vec_obj(q, _BETA)
    b = _vec_obj(q, _BSM)
    B = np.empty((3, 3), dtype=object)
    db = np.empty((3, 3), dtype=object)
    dB = np.empty((3, 3, 3), dtype=object)
    for k in range(3):
        for i in range(3):
            B[k, i] = _vsl(q, _BB.start + 3 * k + i)
            db[k, i] = _dsl(dq3, k, _BSM.start + i)
            for l in range(3):
                dB[k, l, i] = _dsl(dq3, k, _BB.start + 3 * l + i)

    r_al, r_g, r_K, r_th, r_Z, r_A, r_D = _z4_core_soa(
        al, g, K, th, Z, A, D, dK, dth, dZ, dA, dD,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )

    # Primary Lie-derivative terms (same index conventions as the
    # einsum path, models/z4.py::z4_shift_rhs).
    r_al = r_al + al * E("k,k->", beta, A)
    r_g = (
        r_g
        + _omap(lambda x: 2.0 * x, E("k,kij->ij", beta, D))
        + E("ik,kj->ij", B, g)
        + E("jk,ki->ij", B, g)
    )
    r_K = (
        r_K
        + E("k,kij->ij", beta, dK)
        + E("ik,kj->ij", B, K)
        + E("jk,ki->ij", B, K)
    )
    r_th = r_th + E("k,k->", beta, dth)
    r_Z = r_Z + E("k,ki->i", beta, dZ) + E("ik,k->i", B, Z)
    r_A = r_A + E("km,m->k", B, A) + E("m,km->k", beta, dA)
    r_D = (
        r_D
        + E("km,mij->kij", B, D)
        + E("m,kmij->kij", beta, dD)
        + E("im,kmj->kij", B, D)
        + E("jm,kmi->kij", B, D)
        + _omap(lambda x: 0.5 * x, E("kim,mj->kij", dB, g))
        + _omap(lambda x: 0.5 * x, E("kjm,mi->kij", dB, g))
    )

    zero = jnp.zeros_like(al)
    if shift == "frozen":
        extra = [zero] * 15
    elif shift == "gamma_driver":
        # ∂_t Γ^i by the explicit chain rule along the full (post-Lie)
        # (∂_t γ, ∂_t D) — matching the einsum path's jvp exactly.
        gi, _ = _oinv3(g)
        Glow = (
            np.transpose(D, (2, 0, 1)) + np.transpose(D, (2, 1, 0)) - D
        )
        dgi_t = _omap(
            lambda x: -x, E("am,bn,mn->ab", gi, gi, _osym(r_g))
        )
        dGlow_t = (
            np.transpose(r_D, (2, 0, 1))
            + np.transpose(r_D, (2, 1, 0))
            - r_D
        )
        dt_gamma = (
            E("il,jk,ljk->i", dgi_t, gi, Glow)
            + E("il,jk,ljk->i", gi, dgi_t, Glow)
            + E("il,jk,ljk->i", gi, gi, dGlow_t)
        )
        extra = [f_b * b[i] for i in range(3)]
        extra += [dt_gamma[i] - eta * b[i] for i in range(3)]
        for k in range(3):
            extra += [f_b * db[k, i] for i in range(3)]
    else:
        raise ValueError(f"unknown shift mode {shift!r}")
    return _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D, extra)
