"""Coupled Z4 + GRHD (dynamic spacetime with matter) validation.

Layers of evidence, mirroring tests/test_z4.py's vacuum strategy:

1. an INDEPENDENT second-order autodiff oracle — analytic metric AND
   matter fields, every covariant object (Christoffels, Ricci, covariant
   divergences, metric determinant derivatives) from ``jax.jacfwd`` with
   no D/A first-order variables anywhere, and the matter coupling terms
   typed independently from textbook 3+1 forms — must match every one of
   the 43 RHS components;
2. consistency reductions: zero matter reduces to the vacuum
   :func:`z4_rhs`; flat frozen metric reduces the hydro sector to SRHD;
3. the FLRW cosmology anchor: the full nonlinear coupled PDE system on
   homogeneous data reduces to the Friedmann ODEs — evolved against an
   independent machine-precision RK4 reference, converging at the ADER
   predictor's temporal order (N+1);
4. composition: limiter admissibility/step on the coupled system, and
   the sharded step matching single-device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models import srhd
from exahype_jax.models.z4 import N_VARS as N_Z4
from exahype_jax.models.z4 import z4_rhs
from exahype_jax.models.z4_matter import (
    EIGHT_PI,
    N_VARS,
    flrw_reference,
    flrw_state,
    flrw_values,
    make_z4_matter_solver,
    pack_matter,
    recover,
    z4_matter_admissible,
    z4_matter_flux,
    z4_matter_rhs,
    z4_matter_rhs_soa,
    z4_matter_system,
)

GAMMA = 5.0 / 3.0


# ----------------------------------------------------------- field setup


def _make_fields(seed=3, hydro_scale=0.02):
    """Smooth analytic metric + matter fields of x ∈ R³ (periodic-free
    pointwise test).  Metric near flat, fluid mildly relativistic."""
    rng = np.random.default_rng(seed)

    def fourier(amp):
        k = rng.integers(1, 3, size=(2, 3)).astype(np.float64)
        ph = rng.uniform(0, 2 * np.pi, size=2)
        a = rng.uniform(-amp, amp, size=2)

        def fn(x):
            return sum(
                a[i] * jnp.sin(2 * np.pi * (k[i] @ x) + ph[i])
                for i in range(2)
            )

        return fn

    f_al = fourier(0.05)
    f_g = [[fourier(0.04) for _ in range(3)] for _ in range(3)]
    f_K = [[fourier(0.03) for _ in range(3)] for _ in range(3)]
    f_th = fourier(0.02)
    f_Z = [fourier(0.02) for _ in range(3)]
    f_rho = fourier(hydro_scale)
    f_p = fourier(hydro_scale)
    f_v = [fourier(hydro_scale) for _ in range(3)]

    def alpha(x):
        return 1.0 + f_al(x)

    def gam(x):
        out = jnp.eye(3)
        pert = jnp.stack(
            [jnp.stack([f_g[i][j](x) for j in range(3)]) for i in range(3)]
        )
        pert = 0.5 * (pert + pert.T)
        return out + pert

    def K(x):
        pert = jnp.stack(
            [jnp.stack([f_K[i][j](x) for j in range(3)]) for i in range(3)]
        )
        return 0.5 * (pert + pert.T)

    def theta(x):
        return f_th(x)

    def Z(x):
        return jnp.stack([f_Z[i](x) for i in range(3)])

    def rho(x):
        return 1.0 + f_rho(x)

    def p(x):
        return 0.5 + f_p(x)

    def v_low(x):
        return jnp.stack([f_v[i](x) for i in range(3)])

    return alpha, gam, K, theta, Z, rho, p, v_low


def _first_order_state(alpha, gam, K, theta, Z, rho, p, v_low):
    """x → the 43-component coupled state (D/A from autodiff, hydro
    densitized on the local metric)."""
    from exahype_jax.models.z4 import pack

    def state(x):
        al = alpha(x)
        g = gam(x)
        dal = jax.jacfwd(alpha)(x)
        A = dal / al
        dg = jax.jacfwd(gam)(x)  # [i, j, k] = ∂_k γ_ij
        D = 0.5 * jnp.transpose(dg, (2, 0, 1))
        z4 = pack(al, g, K(x), theta(x), Z(x), A, D)
        return pack_matter(z4, rho(x), v_low(x), p(x), gamma=GAMMA)[..., :]

    return state


def _oracle_rhs(alpha, gam, K, theta, Z, rho_f, p_f, v_f, *,
                slicing="harmonic", f=1.0, m=2.0, kappa1=0.0, kappa2=0.0,
                matter_fn=None):
    """Independent coupled RHS: vacuum Z4 oracle (autodiff geometry) plus
    independently-typed matter terms — 3+1 perfect-fluid projections and
    the zero-shift Valencia sources, every metric derivative from
    ``jax.jacfwd`` (no D/A anywhere).

    ``matter_fn(x) -> (E, S_low, S_ij, S_tr)`` overrides the perfect-fluid
    stress-energy projections — the hook `tests/test_z4_grmhd.py` uses to
    drive the SAME independent geometry with the TOTAL (fluid + EM)
    projections from a covariant 4-tensor construction.  The Valencia
    sources (rows 39-42) then also carry the supplied total S^{ik}."""
    from exahype_jax.models.z4 import _slicing, pack

    g_of, _ = _slicing(slicing, f)

    def christoffel(x):
        g = gam(x)
        gi = jnp.linalg.inv(g)
        dg = jax.jacfwd(gam)(x)  # [i, j, k] = ∂_k g_ij
        # Γ^k_ij = ½ γ^kl (∂_i γ_jl + ∂_j γ_il − ∂_l γ_ij)
        low = (
            jnp.einsum("jli->lij", dg)
            + jnp.einsum("ilj->lij", dg)
            - jnp.einsum("ijl->lij", dg)
        )
        return 0.5 * jnp.einsum("kl,lij->kij", gi, low)

    def ricci(x):
        def Gfn(y):
            return christoffel(y)

        G = Gfn(x)
        dG = jax.jacfwd(Gfn)(x)  # [k, i, j, l] = ∂_l Γ^k_ij
        return (
            jnp.einsum("kijk->ij", dG)
            - jnp.einsum("kkji->ij", dG)
            + jnp.einsum("kkl,lij->ij", G, G)
            - jnp.einsum("kli,lkj->ij", G, G)
        )

    def _perfect_fluid_matter(x):
        """(E, S_i, S_ij, S) of the perfect fluid at x."""
        g = gam(x)
        gi = jnp.linalg.inv(g)
        rho, p = rho_f(x), p_f(x)
        vl = v_f(x)
        v2 = vl @ gi @ vl
        W = 1.0 / jnp.sqrt(1.0 - v2)
        h = 1.0 + p / ((GAMMA - 1.0) * rho) + p / rho
        rhohW2 = rho * h * W * W
        E = rhohW2 - p
        S = rhohW2 * vl
        Sij = rhohW2 * jnp.outer(vl, vl) + p * g
        Str = rhohW2 * v2 + 3.0 * p
        return E, S, Sij, Str

    matter = matter_fn if matter_fn is not None else _perfect_fluid_matter

    def rhs(x):
        al = alpha(x)
        g = gam(x)
        gi = jnp.linalg.inv(g)
        Km = K(x)
        th = theta(x)
        Zv = Z(x)
        G = christoffel(x)
        R = ricci(x)
        R = 0.5 * (R + R.T)

        dal = jax.jacfwd(alpha)(x)
        hess_al = jax.jacfwd(jax.jacfwd(alpha))(x)
        covdd_al = 0.5 * (hess_al + hess_al.T) - jnp.einsum(
            "kij,k->ij", G, dal
        )
        dZ = jax.jacfwd(Z)(x)
        covZ = dZ.T - jnp.einsum("kij,k->ij", G, Zv)
        trK = jnp.einsum("ij,ij->", gi, Km)
        Kup = gi @ Km @ gi
        K2 = jnp.einsum("ij,ij->", Km, Kup)
        KK = Km @ gi @ Km
        Kmix = jnp.einsum("jl,il->ij", gi, Km)

        def trK_fn(y):
            return jnp.einsum("ij,ij->", jnp.linalg.inv(gam(y)), K(y))

        dtrK = jax.jacfwd(trK_fn)(x)
        dK = jax.jacfwd(K)(x)
        divKi = (
            jnp.einsum("jl,ilj->i", gi, dK)
            - jnp.einsum("jl,mji,ml->i", gi, G, Km)
            - jnp.einsum("jl,mjl,im->i", gi, G, Km)
        )
        dth = jax.jacfwd(theta)(x)
        Rs = jnp.einsum("ij,ij->", gi, R)
        divZ = jnp.einsum("ij,ij->", gi, covZ)
        Zup = gi @ Zv

        E, S, Sij, Str = matter(x)

        r_al = -(al**2) * g_of(al) * (trK - m * th)
        r_g = -2.0 * al * Km
        r_K = (
            -covdd_al
            + al * (R + covZ + covZ.T - 2.0 * KK + (trK - 2.0 * th) * Km)
            - kappa1 * (1.0 + kappa2) * al * th * g
            - EIGHT_PI * al * (Sij - 0.5 * (Str - E) * g)
        )
        r_th = (
            0.5 * al * (Rs + 2.0 * divZ + (trK - 2.0 * th) * trK - K2)
            - Zup @ dal
            - kappa1 * (2.0 + kappa2) * al * th
            - EIGHT_PI * al * E
        )
        r_Z = (
            al * (divKi - dtrK + dth - 2.0 * (Kmix @ Zv))
            - th * dal
            - kappa1 * al * Zv
            - EIGHT_PI * al * S
        )

        def gauge_scalar(y):
            a = alpha(y)
            return a * g_of(a) * (
                jnp.einsum("ij,ij->", jnp.linalg.inv(gam(y)), K(y))
                - m * theta(y)
            )

        r_A = -jax.jacfwd(gauge_scalar)(x)

        def aK(y):
            return alpha(y) * K(y)

        daK = jax.jacfwd(aK)(x)
        r_D = -jnp.transpose(daK, (2, 0, 1))

        # Hydro sources, independently typed: s(S̃_j) = √γ(α/2 S^{ik}
        # ∂_j γ_ik − E ∂_j α), s(τ̃) = √γ(α S^{ik} K_ik − S^k ∂_k α),
        # with S^{ik} = γ^{ia} γ^{kb} S_ab the UPPER-index stress.
        sqg = jnp.sqrt(jnp.linalg.det(g))
        Sup = gi @ Sij @ gi
        dg = jax.jacfwd(gam)(x)  # [i, k, j] = ∂_j γ_ik
        s_S = sqg * (
            0.5 * al * jnp.einsum("ik,ikj->j", Sup, dg) - E * dal
        )
        s_tau = sqg * (
            al * jnp.einsum("ik,ik->", Sup, Km) - (gi @ S) @ dal
        )
        z4_part = pack(r_al, r_g, r_K, r_th, r_Z, r_A, r_D)
        return jnp.concatenate(
            [z4_part, jnp.zeros((1,)), s_S, s_tau[None]]
        )

    return rhs


# ----------------------------------------------------------- oracle test


@pytest.mark.parametrize(
    "slicing,f,kappa1,kappa2",
    [("harmonic", 1.0, 0.0, 0.0), ("1+log", 1.0, 0.2, 0.1)],
)
def test_rhs_matches_autodiff_oracle(slicing, f, kappa1, kappa2):
    """Every one of the 43 coupled RHS components equals the independent
    second-order autodiff oracle on random smooth metric+matter fields."""
    m = 2.0
    fields = _make_fields(seed=3)
    state = _first_order_state(*fields)
    oracle = _oracle_rhs(
        *fields, slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2
    )
    rng = np.random.default_rng(7)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(5, 3)))

    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)
    got = z4_matter_rhs(
        q, dq3, gamma=GAMMA, iters=20,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
    )
    want = jax.vmap(oracle)(pts)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=2e-10
    )


def test_soa_rhs_matches_einsum_rhs():
    """The component-unrolled production twin reproduces the validated
    einsum RHS to rounding on random fields."""
    fields = _make_fields(seed=5)
    state = _first_order_state(*fields)
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(4, 3)))
    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)
    kw = dict(gamma=GAMMA, iters=12, slicing="harmonic", f=0.9, m=2.0,
              kappa1=0.3, kappa2=0.1)
    a = z4_matter_rhs(q, dq3, **kw)
    b = z4_matter_rhs_soa(q, dq3, **kw)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-12)


def test_zero_matter_reduces_to_vacuum():
    """With a near-vacuum fluid (ρ, p → tiny) the Z4 rows approach the
    vacuum RHS linearly in the matter scale."""
    fields = _make_fields(seed=3, hydro_scale=0.0)
    alpha, gam, K, theta, Z, _, _, _ = fields
    rng = np.random.default_rng(7)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(4, 3)))

    errs = []
    for scale in (1e-6, 1e-8):
        def rho(x):
            return scale * 1.0 + 0.0 * x[0]

        def p(x):
            return scale * 0.5 + 0.0 * x[0]

        def v(x):
            return jnp.zeros(3) * x[0]

        state = _first_order_state(alpha, gam, K, theta, Z, rho, p, v)
        q = jax.vmap(state)(pts)
        dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)
        got = z4_matter_rhs(q, dq3, gamma=GAMMA)[..., :N_Z4]
        want = z4_rhs(q[..., :N_Z4], dq3[..., :N_Z4])
        errs.append(
            float(jnp.max(jnp.abs(got - want)))
        )
    assert errs[0] < 1e-4 and errs[1] < errs[0] * 1e-1


def test_flat_frozen_metric_reduces_to_srhd():
    """On Minkowski the hydro flux rows equal the flat SRHD fluxes and the
    geometric sources vanish."""
    from exahype_jax.models.z4 import flat_state_values

    rng = np.random.default_rng(0)
    n = 7
    rho = 1.0 + 0.3 * rng.random(n)
    p = 0.5 + 0.2 * rng.random(n)
    v = 0.3 * (rng.random((n, 3)) - 0.5)
    z4 = jnp.asarray(np.broadcast_to(flat_state_values(), (n, N_Z4)))
    q = pack_matter(z4, jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p),
                    gamma=GAMMA)
    # Sources vanish on flat frozen space.
    src = z4_matter_rhs(q, jnp.zeros((n, 3, N_VARS)), gamma=GAMMA)
    np.testing.assert_allclose(
        np.asarray(src[..., N_Z4:]), 0.0, atol=1e-13
    )
    # Fluxes match SRHD (3 momentum components, flat metric, α = √γ = 1).
    hydro = srhd.prim_to_cons(
        jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p), gamma=GAMMA
    )
    for d in range(3):
        got = z4_matter_flux(q, d, var_axis=-1, gamma=GAMMA)[..., N_Z4:]
        want = srhd.srhd_flux(hydro, d, gamma=GAMMA)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), atol=1e-11
        )


def test_ncp_source_split_is_exact():
    """source − Σ_d ncp_d + (−∂·F handled by the solver) reproduces the
    full RHS: affinity of the coupled algebra through the solver-contract
    callbacks."""
    fields = _make_fields(seed=11)
    state = _first_order_state(*fields)
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(4, 3)))
    q = jax.vmap(state)(pts)
    dq3 = jnp.swapaxes(jax.vmap(jax.jacfwd(state))(pts), -1, -2)

    kw = dict(gamma=GAMMA, slicing="harmonic", f=1.0, m=2.0,
              kappa1=0.3, kappa2=0.2)
    flux, eig, ncp, source = z4_matter_system(**kw)
    Qv = jnp.moveaxis(q, -1, 0)
    total = source(Qv, 0)
    for d in range(3):
        total = total - ncp(Qv, jnp.moveaxis(dq3[:, d, :], -1, 0), d, 0)
    want = z4_matter_rhs(q, dq3, **kw)
    np.testing.assert_allclose(
        np.asarray(jnp.moveaxis(total, 0, -1)), np.asarray(want),
        atol=1e-11,
    )
    # Z4 rows carry no flux; hydro rows carry no NCP.
    F = flux(Qv, 0, 0)
    assert np.all(np.asarray(F[:N_Z4]) == 0.0)
    n = ncp(Qv, Qv, 0, 0)
    np.testing.assert_allclose(np.asarray(n[N_Z4:]), 0.0, atol=1e-11)
    lam = np.asarray(eig(Qv, 0, 0))
    assert lam.shape == (4,) and np.all(lam > 0.5)


# ------------------------------------------------------------ FLRW anchor


def test_flrw_initial_data_satisfies_constraints():
    """The FLRW construction satisfies the Hamiltonian constraint with
    matter: K² − K_ij K^ij = 16π E (flat slices, R = 0)."""
    rho0, eps0 = 0.01, 0.3
    vals = flrw_values(1.0, np.sqrt(8 * np.pi * rho0 * (1 + eps0) / 3),
                       rho0=rho0, eps0=eps0, gamma=GAMMA)
    q = jnp.asarray(vals)[None]
    from exahype_jax.models.z4 import adm_constraints

    H, M = adm_constraints(q[..., :N_Z4], jnp.zeros((1, 3, N_Z4)))
    E = rho0 * (1.0 + eps0)
    np.testing.assert_allclose(float(H[0]), 16 * np.pi * E, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(M), 0.0, atol=1e-15)


@pytest.mark.parametrize("eps0", [0.0, 0.4])
def test_flrw_matches_friedmann_reference(eps0):
    """The coupled solver evolves a homogeneous Γ-law universe; the scale
    factor (via γ_xx) and fluid density match the independent RK4
    Friedmann reference to high accuracy, and Θ/Z stay at rounding."""
    rho0 = 0.02
    solver = make_z4_matter_solver(
        dim=2, order=2, grid_shape=(4, 4), dx=0.25,
        gamma=GAMMA, slicing="harmonic", f=0.0,  # geodesic slicing
    )
    Q0 = flrw_state(
        solver, 1.0,
        np.sqrt(8 * np.pi * rho0 * (1 + eps0) / 3),
        rho0=rho0, eps0=eps0, gamma=GAMMA,
    )
    T, n_steps = 0.5, 100
    Q = solver.run(Q0, n_steps, T / n_steps)
    a_ref, adot_ref = flrw_reference(
        T, rho0=rho0, eps0=eps0, gamma=GAMMA
    )
    q = np.moveaxis(np.asarray(Q), solver.var_axis, -1)
    gxx = q[..., 1]
    Kxx = q[..., 7]
    np.testing.assert_allclose(gxx, a_ref**2, rtol=1e-8)
    np.testing.assert_allclose(Kxx, -a_ref * adot_ref, rtol=1e-7)
    # Baryon density: D̃ = √γ ρ = a³ ρ₀/a³ = ρ₀ exactly (conservation).
    np.testing.assert_allclose(q[..., N_Z4], rho0, rtol=1e-10)
    # Constraint sector stays at rounding.
    assert float(np.abs(q[..., 13]).max()) < 1e-10  # Θ
    assert float(np.abs(q[..., 14:17]).max()) < 1e-10  # Z


@pytest.mark.slow
def test_flrw_temporal_convergence_order():
    """dt-refinement of the FLRW run converges at the ADER predictor's
    temporal order (≥ N+1 = 3 at order 2)."""
    rho0, eps0 = 0.02, 0.4
    solver = make_z4_matter_solver(
        dim=2, order=2, grid_shape=(4, 4), dx=0.25,
        gamma=GAMMA, slicing="harmonic", f=0.0,
    )
    T = 0.5
    a_ref, adot_ref = flrw_reference(T, rho0=rho0, eps0=eps0, gamma=GAMMA)
    errs = []
    for n_steps in (4, 8, 16):
        Q0 = flrw_state(
            solver, 1.0, np.sqrt(8 * np.pi * rho0 * (1 + eps0) / 3),
            rho0=rho0, eps0=eps0, gamma=GAMMA,
        )
        Q = solver.run(Q0, n_steps, T / n_steps)
        q = np.moveaxis(np.asarray(Q), solver.var_axis, -1)
        errs.append(abs(float(q[..., 1].ravel()[0]) - a_ref**2))
    r1 = np.log2(errs[0] / errs[1])
    r2 = np.log2(errs[1] / errs[2])
    assert min(r1, r2) > 2.5, (errs, r1, r2)


# ----------------------------------------------------------- composition


def test_limiter_composes_with_coupled_system():
    """LimitedADERDG over the coupled system: an FLRW state with a strong
    localized density bump stays finite and admissible through limited
    steps (DMP detection + subcell fallback on the 43-var system)."""
    from exahype_jax.models.limiter import LimitedADERDG

    rho0, eps0 = 0.02, 0.3
    solver = make_z4_matter_solver(
        dim=2, order=2, grid_shape=(6, 6), dx=1.0 / 6,
        gamma=GAMMA, slicing="harmonic", f=0.0,
    )
    limited = LimitedADERDG(
        solver, admissible=z4_matter_admissible(gamma=GAMMA)
    )
    Q = flrw_state(
        solver, 1.0, np.sqrt(8 * np.pi * rho0 * (1 + eps0) / 3),
        rho0=rho0, eps0=eps0, gamma=GAMMA,
    )
    # Strong density/pressure bump: force the limiter to engage.
    coords = solver.nodes_meshgrid()
    x = jnp.squeeze(jnp.asarray(coords[0]), solver.var_axis)
    y = jnp.squeeze(jnp.asarray(coords[1]), solver.var_axis)
    bump = 1.0 + 4.0 * jnp.exp(
        -(((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.01)
    )
    q = jnp.moveaxis(Q, solver.var_axis, -1)
    q = q.at[..., N_Z4].mul(bump[..., None].squeeze(-1))
    q = q.at[..., N_Z4 + 4].mul(bump[..., None].squeeze(-1))
    Q = jnp.moveaxis(q, -1, solver.var_axis)
    adm = z4_matter_admissible(gamma=GAMMA)
    assert bool(np.asarray(adm(Q, solver.var_axis)).all())
    out = Q
    for _ in range(3):
        out = limited.step(out, 2e-3)
    on = np.asarray(out)
    assert np.isfinite(on).all()
    assert bool(np.asarray(adm(out, solver.var_axis)).all())
    # The limiter actually engaged on the bump.
    cand = solver.step(Q, 2e-3)
    t = limited.troubled_mask(Q, cand)
    assert int(np.asarray(t).sum()) > 0


def test_sharded_coupled_step_matches_single_device():
    """The coupled step under a 2-device GSPMD mesh equals single-device
    to rounding (the vacuum-Z4 sharding path extends to 43 vars)."""
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    rho0 = 0.02
    solver = make_z4_matter_solver(
        dim=2, order=2, grid_shape=(8, 4), dx=0.25,
        gamma=GAMMA, slicing="harmonic", f=0.0,
    )
    Q = flrw_state(
        solver, 1.0, np.sqrt(8 * np.pi * rho0 / 3), rho0=rho0,
        gamma=GAMMA,
    )
    # Perturb so the answer is not trivially uniform.
    coords = solver.nodes_meshgrid()
    x = jnp.squeeze(jnp.asarray(coords[0]), solver.var_axis)
    q = jnp.moveaxis(Q, solver.var_axis, -1)
    q = q.at[..., N_Z4].mul(1.0 + 0.05 * jnp.sin(2 * np.pi * x)[..., None].squeeze(-1))
    Q = jnp.moveaxis(q, -1, solver.var_axis)

    want = np.asarray(solver.step(Q, 1e-3))
    mesh = make_mesh(2)
    spec = [None] * len(solver.state_shape)
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    Qs = jax.device_put(Q, sharding)
    got = np.asarray(
        jax.jit(lambda u: solver.step(u, 1e-3),
                in_shardings=(sharding,), out_shardings=sharding)(Qs)
    )
    np.testing.assert_allclose(got, want, atol=5e-12)
