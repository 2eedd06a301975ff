"""Coupled matter + dynamic spacetime: Z4 + general-relativistic hydro.

The missing family rung above :mod:`~exahype_jax.models.z4` (vacuum
dynamic spacetime) and :mod:`~exahype_jax.models.grhd` (matter on a
FROZEN metric): the Einstein equations sourced by a perfect fluid, with
the fluid evolved on the dynamic metric — the configuration the
downstream ExaHyPE astrophysics programme (ExaGRyPE: FO-CCZ4 + GRMHD)
exists for.  Reference-family context: the reference repo bundles only
Euler physics (``Unit test/Functions.cpp:9-62``); this is a
family-capability module, not a reference-parity one.

State (43 variables, var-last in the ``*_rhs`` functions): the 38
zero-shift Z4 variables of :mod:`z4` followed by the DENSITIZED Valencia
hydro block

    Q = [ α, γ_ij, K_ij, Θ, Z_i, A_k, D_kij,  D̃, S̃_i (3), τ̃ ]

with D̃ = √γ ρW, S̃_i = √γ ρhW² v_i, τ̃ = √γ (ρhW² − p) − D̃ (G = c = 1,
ideal-gas EOS p = (Γ−1)ρε; always three momentum components — tensor
algebra is 3-D even on lower-dimensional grids, matching the Z4
convention).  Densitizing by √γ (evolved, via det γ_ij) makes the hydro
sector a CONSERVATIVE flux-form system on the curved dynamic metric;
every geometric source is ALGEBRAIC in the evolved first-order Z4
variables (∂_k γ_ij = 2 D_kij, ∂_k α = α A_k), so the coupling needs no
gradient evaluation anywhere — the analogue of the
fixed-metric trick :mod:`grhd` uses.

Equations added to the vacuum Z4 right-hand side (trace-reversed matter
sources, Alic et al. 2012 conventions; E = ρhW² − p, S_i = ρhW² v_i,
S_ij = ρhW² v_i v_j + p γ_ij, S = γ^{ij} S_ij):

    ∂_t K_ij += −8πα [ S_ij − ½ γ_ij (S − E) ]
    ∂_t Θ    += −8πα E
    ∂_t Z_i  += −8πα S_i

and the Valencia hydro sector (zero shift):

    ∂_t D̃   + ∂_d (α D̃ v^d)                = 0
    ∂_t S̃_j + ∂_d (α [S̃_j v^d + √γ p δ^d_j]) = α√γ (S^{ik} D_jik − E A_j)
    ∂_t τ̃   + ∂_d (α [τ̃ + √γ p] v^d)        = α√γ (S^{ik} K_ik − S^k A_k)

Conservative-to-primitive recovery reuses the safeguarded bracketed
Newton of :func:`~exahype_jax.models.srhd.con2prim` unchanged: after
un-densitizing, the scalar problem depends on the metric only through
|S|²_γ = γ^{ij} S_i S_j, so the curved recovery is the flat one fed the
curved momentum norm.

Validation (``tests/test_z4_matter.py``): every RHS component against an
independent second-order autodiff oracle (analytic metric AND matter
fields, Ricci/Christoffels/covariant divergences from ``jax.jacfwd``, no
D/A variables anywhere — the :mod:`z4` oracle pattern extended with
independently-typed matter terms); flat + static fluid consistency; the
FLRW (Friedmann) cosmology anchor — a Γ-law homogeneous universe where
the full coupled nonlinear system reduces to the Friedmann ODEs,
integrated to machine precision by an independent RK4 — matching at the
ADER predictor's temporal order; limiter and multi-chip sharding
composition.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.models import srhd
from exahype_jax.models.z4 import (
    N_VARS as N_Z4,
    SYM6,
    _A,
    _AL,
    _D,
    _G,
    _K,
    _TH,
    _Z,
    _slicing,
    _z4_core,
    inv3,
    mat_to_sym,
    pack,
    sym_to_mat,
    unpack,
)

#: Every einsum of state at HIGHEST precision (see models/aderdg.py).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

EIGHT_PI = 8.0 * np.pi

N_HYDRO = 5
N_VARS = N_Z4 + N_HYDRO  # 43

_HD = N_Z4  # D̃
_HS = slice(N_Z4 + 1, N_Z4 + 4)  # S̃_i
_HTAU = N_Z4 + 4  # τ̃


# ------------------------------------------------------------- recovery


def recover(q, *, gamma: float = 5.0 / 3.0, iters: int = 10):
    """Curved-metric con2prim on the var-last coupled state.

    Returns ``(rho, v_low[3], p, W, sqg, gi)``: primitive density,
    COVARIANT velocity v_i, pressure, Lorentz factor, √γ, and the inverse
    spatial metric — everything the fluxes/sources need, computed once.
    """
    g = sym_to_mat(q[..., _G])
    gi, detg = inv3(g)
    sqg = jnp.sqrt(detg)
    D = q[..., _HD] / sqg
    S = q[..., _HS] / sqg[..., None]  # lower index
    tau = q[..., _HTAU] / sqg
    S2 = _einsum("...ij,...i,...j->...", gi, S, S)
    Smag = jnp.sqrt(jnp.maximum(S2, 0.0))
    flat = jnp.stack([D, Smag, tau], axis=-1)
    rho, _, p, W = srhd.con2prim(flat, gamma=gamma, iters=iters)
    v_low = S / (tau + D + p)[..., None]  # v_i = S_i / (ρhW²)
    return rho, v_low, p, W, sqg, gi


def stress_energy(q, *, gamma: float = 5.0 / 3.0, iters: int = 10):
    """Matter projections (E, S_i, S_ij, trace S) from the coupled state —
    the n^μ-decomposed perfect-fluid stress energy the Z4 sector consumes.
    """
    rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
    g = sym_to_mat(q[..., _G])
    rhohW2 = (q[..., _HTAU] + q[..., _HD]) / sqg + p  # ρhW²
    E = rhohW2 - p
    S_low = rhohW2[..., None] * v_low
    S_ij = (
        rhohW2[..., None, None]
        * _einsum("...i,...j->...ij", v_low, v_low)
        + p[..., None, None] * g
    )
    v2 = _einsum("...ij,...i,...j->...", gi, v_low, v_low)
    S_tr = rhohW2 * v2 + 3.0 * p
    return E, S_low, S_ij, S_tr


# ------------------------------------------------------------------ RHS


def z4_matter_rhs(
    q,
    dq3,
    *,
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
):
    """Complete coupled right-hand side EXCLUDING the hydro flux
    divergence (which is conservative and lives in
    :func:`z4_matter_flux`): the vacuum Z4 RHS plus matter sources on
    (K, Θ, Z), plus the algebraic hydro geometric sources.

    ``q``: [..., 43] var-last; ``dq3``: [..., 3, 43].  Affine in ``dq3``
    (the matter terms carry no derivatives at all), so the solver's
    NCP/source split follows by linearity exactly as in :mod:`z4`.
    """
    al, g, K, th, Z, A, D = unpack(q[..., :N_Z4])
    dz = dq3[..., :N_Z4]
    dK = sym_to_mat(dz[..., _K])
    dth = dz[..., _TH]
    dZ = dz[..., _Z]
    dA = dz[..., _A]
    dD = sym_to_mat(dz[..., _D].reshape(dz.shape[:-1] + (3, 6)))
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

    # Hydro geometric sources (all algebraic in the evolved Z4 state).
    rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
    rhohW2 = E + p
    v_up = _einsum("...ij,...j->...i", gi, v_low)
    S_up2 = (
        rhohW2[..., None, None]
        * _einsum("...i,...j->...ij", v_up, v_up)
        + p[..., None, None] * gi
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
    z4_part = pack(r_al, r_g, r_K, r_th, r_Z, r_A, r_D)
    return jnp.concatenate(
        [z4_part, r_Dt[..., None], r_S, r_tau[..., None]], axis=-1
    )


def z4_matter_flux(Q, axis, var_axis, *, gamma: float = 5.0 / 3.0,
                   iters: int = 10):
    """Conservative flux along grid ``axis``: Valencia hydro rows on the
    dynamic metric, zero Z4 rows (pure NCP sector)."""
    q = jnp.moveaxis(Q, var_axis, -1)
    al = q[..., _AL]
    rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
    vd = _einsum("...j,...j->...", gi[..., axis, :], v_low)  # v^d
    Dt = q[..., _HD]
    St = q[..., _HS]
    taut = q[..., _HTAU]
    psg = p * sqg
    f_D = al * Dt * vd
    # Pressure enters only the ``axis`` momentum row: add via a one-hot
    # broadcast (stack-free, no scatter).
    f_S = al[..., None] * (St * vd[..., None]) + (al * psg)[
        ..., None
    ] * jnp.asarray(np.eye(3)[axis], q.dtype)
    f_tau = al * (taut + psg) * vd
    out = jnp.concatenate(
        [
            jnp.zeros(q.shape[:-1] + (N_Z4,), q.dtype),
            f_D[..., None],
            f_S,
            f_tau[..., None],
        ],
        axis=-1,
    )
    return jnp.moveaxis(out, -1, var_axis)


def z4_matter_eig(Q, axis, var_axis, *, slicing: str = "harmonic",
                  f: float = 1.0):
    """Rusanov speed bound: the wider of the gauge and light cones,
    α √(max(g(α), 1) γ^dd) — relativistic hydro characteristics lie
    inside the light cone, so one bound covers both sectors."""
    q = jnp.moveaxis(Q, var_axis, -1)
    al = q[..., _AL]
    gi, _ = inv3(sym_to_mat(q[..., _G]))
    gdd = gi[..., axis, axis]
    g_of, _ = _slicing(slicing, f)
    return al * jnp.sqrt(jnp.maximum(g_of(al), 1.0) * gdd)


# ------------------------------------------------------------ system


def z4_matter_system(
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    impl: str = "einsum",
):
    """(flux_fn, max_eigenvalue_fn, ncp_fn, source_fn) in the solver
    ``(Q, axis, var_axis)`` contract.  ``impl='soa'`` routes the
    NCP/source algebra through the component-unrolled twin
    :func:`z4_matter_rhs_soa` (as in
    :func:`~exahype_jax.models.z4.z4_system`)."""
    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m,
              kappa1=kappa1, kappa2=kappa2)

    rhs_impl = z4_matter_rhs_soa if impl == "soa" else z4_matter_rhs

    def _rhs(q, dq3):
        return rhs_impl(q, dq3, **kw)

    def flux(Q, axis, va):
        return z4_matter_flux(Q, axis, va, gamma=gamma, iters=iters)

    def eig(Q, axis, va):
        return z4_matter_eig(Q, axis, va, slicing=slicing, f=f)

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


def make_z4_matter_solver(
    dim: int,
    order: int,
    grid_shape: tuple,
    dx=1.0,
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
    impl: str = "einsum",
    fused_rhs=False,
    **kwargs,
):
    """A fully-configured coupled Z4+GRHD ADER-DG solver.  ``fused_rhs``
    installs the one-evaluation ``rhs_all_fn`` hook ("soa" = from the
    SoA twin, see :func:`~exahype_jax.models.z4.make_z4_solver`)."""
    from exahype_jax.models.aderdg import ADERDGSolver
    from exahype_jax.models.z4 import _rhs_all_of

    kw = dict(gamma=gamma, iters=iters, slicing=slicing, f=f, m=m,
              kappa1=kappa1, kappa2=kappa2)
    flux, eig, ncp, source = z4_matter_system(impl=impl, **kw)
    if fused_rhs == "soa":
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_matter_rhs_soa(q, dq3, **kw), N_VARS,
        )
    elif fused_rhs:
        rhs_all = _rhs_all_of(
            lambda q, dq3: z4_matter_rhs(q, dq3, **kw), N_VARS
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


def z4_matter_admissible(gamma: float = 5.0 / 3.0, iters: int = 10):
    """Limiter admissibility: positive lapse, positive-definite spatial
    metric (via leading minors), positive hydro recovery, subluminal."""

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        al = q[..., _AL]
        g = sym_to_mat(q[..., _G])
        m1 = g[..., 0, 0]
        m2 = g[..., 0, 0] * g[..., 1, 1] - g[..., 0, 1] ** 2
        _, detg = inv3(g)
        rho, v_low, p, W, sqg, gi = recover(q, gamma=gamma, iters=iters)
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


def pack_matter(z4_vals, rho, v_low, p, *, gamma: float = 5.0 / 3.0):
    """Z4 var-last values [..., 38] + primitives (v_i COVARIANT, 3-vector
    var-last) → coupled state [..., 43] (densitized hydro built on the
    metric inside ``z4_vals``)."""
    z4_vals = jnp.asarray(z4_vals)
    g = sym_to_mat(z4_vals[..., _G])
    gi, detg = inv3(g)
    sqg = jnp.sqrt(detg)
    rho = jnp.asarray(rho)
    p = jnp.asarray(p)
    v_low = jnp.broadcast_to(jnp.asarray(v_low), rho.shape + (3,))
    v2 = _einsum("...ij,...i,...j->...", gi, v_low, v_low)
    W = 1.0 / jnp.sqrt(1.0 - v2)
    eps = p / ((gamma - 1.0) * rho)
    h = 1.0 + eps + p / rho
    rhohW2 = rho * h * W * W
    Dt = sqg * rho * W
    St = (sqg * rhohW2)[..., None] * v_low
    taut = sqg * (rhohW2 - p) - Dt
    return jnp.concatenate(
        [z4_vals, Dt[..., None], St, taut[..., None]], axis=-1
    )


# ---------------------------------------------------------------- FLRW


def flrw_reference(t_end: float, *, rho0: float, eps0: float = 0.0,
                   gamma: float = 5.0 / 3.0, n_rk: int = 200_000,
                   expanding: bool = True):
    """Machine-precision FLRW reference by RK4 on the Friedmann system.

    Flat FLRW, Γ-law perfect fluid: ρ = ρ₀ a⁻³ and ε = ε₀ a^{−3(Γ−1)}
    exactly (baryon + entropy conservation); the scale factor solves

        ä/a = −(4π/3) (E + 3p),  E = ρ(1+ε),  p = (Γ−1)ρε

    from a(0) = 1 and the Hamiltonian constraint ȧ(0) = ±√(8πE₀/3).
    Returns ``(a, adot)`` at ``t_end``.
    """

    def Ep(a):
        rho = rho0 / a**3
        eps = eps0 / a ** (3.0 * (gamma - 1.0))
        E = rho * (1.0 + eps)
        p = (gamma - 1.0) * rho * eps
        return E, p

    E0, _ = Ep(1.0)
    adot = np.sqrt(8.0 * np.pi * E0 / 3.0) * (1.0 if expanding else -1.0)
    a = 1.0
    h = t_end / n_rk

    def deriv(a, adot):
        E, p = Ep(a)
        return adot, -(4.0 * np.pi / 3.0) * (E + 3.0 * p) * a

    for _ in range(n_rk):
        k1a, k1v = deriv(a, adot)
        k2a, k2v = deriv(a + 0.5 * h * k1a, adot + 0.5 * h * k1v)
        k3a, k3v = deriv(a + 0.5 * h * k2a, adot + 0.5 * h * k2v)
        k4a, k4v = deriv(a + h * k3a, adot + h * k3v)
        a += h / 6.0 * (k1a + 2 * k2a + 2 * k3a + k4a)
        adot += h / 6.0 * (k1v + 2 * k2v + 2 * k3v + k4v)
    return a, adot


def flrw_values(a: float, adot: float, *, rho0: float, eps0: float = 0.0,
                gamma: float = 5.0 / 3.0) -> np.ndarray:
    """Var-last [43] coupled state values of the flat-FLRW slice at scale
    factor ``a``: γ_ij = a²δ, K_ij = −aȧδ (geodesic slicing α = 1, use
    ``slicing='harmonic', f=0`` so the lapse stays frozen), homogeneous
    Γ-law fluid at rest."""
    v = np.zeros(N_VARS)
    v[_AL] = 1.0
    v[1] = v[4] = v[6] = a * a  # γ xx, yy, zz
    v[7] = v[10] = v[12] = -a * adot  # K xx, yy, zz
    rho = rho0 / a**3
    eps = eps0 / a ** (3.0 * (gamma - 1.0))
    p = (gamma - 1.0) * rho * eps
    sqg = a**3
    h = 1.0 + eps + p / rho
    v[_HD] = sqg * rho
    v[_HTAU] = sqg * (rho * h - p) - v[_HD]
    return v


def flrw_state(solver, a: float, adot: float, *, rho0: float,
               eps0: float = 0.0, gamma: float = 5.0 / 3.0):
    """Homogeneous FLRW nodal state broadcast to ``solver.state_shape``."""
    vals = flrw_values(a, adot, rho0=rho0, eps0=eps0, gamma=gamma)
    shape = [1] * len(solver.state_shape)
    shape[solver.var_axis] = N_VARS
    return jnp.asarray(
        np.broadcast_to(vals.reshape(shape), solver.state_shape).copy()
    )


# ------------------------------------------------- SoA-unrolled evaluation


def z4_matter_rhs_soa(
    q,
    dq3,
    *,
    gamma: float = 5.0 / 3.0,
    iters: int = 10,
    slicing: str = "harmonic",
    f: float = 1.0,
    m: float = 2.0,
    kappa1: float = 0.0,
    kappa2: float = 0.0,
):
    """Component-unrolled twin of :func:`z4_matter_rhs` (identical algebra
    to rounding — parity-tested): the vacuum SoA core plus matter terms
    evaluated with the object-array helpers, every operation elementwise
    over the grid (see :func:`~exahype_jax.models.z4.z4_rhs_soa`)."""
    from exahype_jax.models.z4 import (
        _oein,
        _oinv3,
        _sym_obj,
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
    Dh = Dt / sqg
    S_low = np.empty((3,), dtype=object)
    for i in range(3):
        S_low[i] = St[i] / sqg
    tau = taut / sqg
    S2 = _oein("ij,i,j->", gi, S_low, S_low)
    Smag = jnp.sqrt(jnp.maximum(S2, 0.0))
    rho, p, W = srhd.con2prim_smag(
        Dh, Smag, tau, gamma=gamma, iters=iters
    )
    rhohW2 = tau + Dh + p
    E = rhohW2 - p
    v_low = np.empty((3,), dtype=object)
    for i in range(3):
        v_low[i] = S_low[i] / rhohW2
    v_up = _oein("ij,j->i", gi, v_low)
    v2 = _oein("i,i->", v_low, v_up)
    S_tr = rhohW2 * v2 + 3.0 * p
    Sm_low = np.empty((3,), dtype=object)
    for i in range(3):
        Sm_low[i] = rhohW2 * v_low[i]
    # Matter terms on the Z4 sector.
    half_tr = 0.5 * (S_tr - E)
    for i in range(3):
        for j in range(3):
            S_ij = rhohW2 * v_low[i] * v_low[j] + p * g[i, j]
            r_K[i, j] = r_K[i, j] - EIGHT_PI * al * (
                S_ij - half_tr * g[i, j]
            )
    r_th = r_th - EIGHT_PI * al * E
    for i in range(3):
        r_Z[i] = r_Z[i] - EIGHT_PI * al * Sm_low[i]

    # Hydro geometric sources.
    Sup = np.empty((3, 3), dtype=object)
    for i in range(3):
        for j in range(3):
            Sup[i, j] = rhohW2 * v_up[i] * v_up[j] + p * gi[i, j]
    asg = al * sqg
    r_S = _oein("ik,jik->j", Sup, D)
    SupK = _oein("ik,ik->", Sup, K)
    S_up_vec = _oein("ij,j->i", gi, Sm_low)
    SA = _oein("k,k->", S_up_vec, A)
    extra = [jnp.zeros_like(al)]
    for j in range(3):
        extra.append(asg * (r_S[j] - E * A[j]))
    extra.append(asg * (SupK - SA))
    return _z4_pack_soa(r_al, r_g, r_K, r_th, r_Z, r_A, r_D,
                        extra=tuple(extra))
