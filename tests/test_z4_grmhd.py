"""Coupled Z4 + GRMHD (magnetized matter on a dynamic spacetime).

Validation strategy (`models/z4_grmhd.py`):

- **Independent stress-energy oracle**: E, S_i, S_ij are re-derived in
  the test from the covariant 4-tensor T^{μν} = ρh*u^μu^ν + p*g^{μν}
  − b^μb^ν (4-velocity and fluid-frame field built from first
  principles, contracted with the normal and the spatial projector) — a
  different derivation path from the module's 3+1 closed forms.
- **Exact reductions**: B = 0 reproduces the validated coupled hydro
  system (`z4_matter`, itself autodiff-oracle checked); a flat frozen
  metric reduces the flux rows to `rmhd` exactly.
- **Recovery round-trip** on a curved metric; SoA twin parity;
  conservation of the flux-form sectors; GLM divergence control;
  limiter and multi-chip sharding composition.

Reference-family context: the reference bundles only flat Euler physics
(`Unit test/Functions.cpp:9-62`); this is the ExaGRyPE flagship rung.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from exahype_jax.models import rmhd
from exahype_jax.models.z4 import N_VARS as N_Z4
from exahype_jax.models.z4_grmhd import (
    N_VARS,
    make_z4_grmhd_solver,
    pack_matter_mhd,
    recover,
    stress_energy,
    z4_grmhd_admissible,
    z4_grmhd_flux,
    z4_grmhd_rhs,
    z4_grmhd_rhs_soa,
)

GAMMA = 5.0 / 3.0


def _rng_fields(n=32, seed=3, curved=True, B_scale=0.3):
    """Random physical primitives + (optionally) a curved metric.

    Returns (z4_vals[.., 38], rho, v_low, p, B_up) with |v| safely
    subluminal in the given metric."""
    rng = np.random.default_rng(seed)
    z4 = np.zeros((n, N_Z4))
    z4[:, 0] = rng.uniform(0.6, 1.2, n)  # α
    # SPD metric: γ = I + 0.3·LLᵀ (curved) or δ.
    if curved:
        L = rng.uniform(-0.3, 0.3, (n, 3, 3))
        g = np.eye(3) + 0.3 * np.einsum("nik,njk->nij", L, L)
        for k in range(3):
            g[:, k, k] += rng.uniform(0.0, 0.4, n)
    else:
        g = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    sym = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    for s, (i, j) in enumerate(sym):
        z4[:, 1 + s] = g[:, i, j]
        z4[:, 7 + s] = rng.uniform(-0.2, 0.2, n) if curved else 0.0  # K
    if curved:
        z4[:, 13] = rng.uniform(-0.1, 0.1, n)        # Θ
        z4[:, 14:20] = rng.uniform(-0.2, 0.2, (n, 6))  # Z, A
        z4[:, 20:38] = rng.uniform(-0.2, 0.2, (n, 18))  # D
    rho = rng.uniform(0.5, 2.0, n)
    p = rng.uniform(0.3, 1.5, n)
    gi = np.linalg.inv(g)
    v_low = rng.uniform(-1.0, 1.0, (n, 3))
    v2 = np.einsum("nij,ni,nj->n", gi, v_low, v_low)
    v_low *= (0.5 / np.sqrt(np.maximum(v2, 1e-30)))[:, None] * rng.uniform(
        0.2, 1.0, n
    )[:, None]
    B_up = B_scale * rng.uniform(-1.0, 1.0, (n, 3))
    return z4, rho, v_low, p, B_up


# --------------------------------------- full 47-component autodiff oracle


def _make_mhd_fields(seed=3, B_scale=0.05):
    """Smooth analytic metric + matter + magnetic fields of x ∈ R³ —
    the magnetized extension of ``test_z4_matter._make_fields`` (same
    near-flat metric and mildly relativistic fluid, plus a smooth B^i
    and GLM scalar)."""
    from tests.test_z4_matter import _make_fields

    base = _make_fields(seed=seed)
    rng = np.random.default_rng(seed + 101)

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

    f_B = [fourier(B_scale) for _ in range(3)]
    f_psi = fourier(0.02)

    def B_up(x):
        return jnp.stack([f_B[i](x) for i in range(3)])

    def psi(x):
        return f_psi(x)

    return base + (B_up, psi)


def _mhd_state(alpha, gam, K, theta, Z, rho, p, v_low, B_up, psi):
    """x → the 47-component coupled state (D/A from autodiff, hydro and
    magnetic sectors densitized on the local metric)."""
    from exahype_jax.models.z4 import pack

    def state(x):
        al = alpha(x)
        g = gam(x)
        A = jax.jacfwd(alpha)(x) / al
        dg = jax.jacfwd(gam)(x)  # [i, j, k] = ∂_k γ_ij
        D = 0.5 * jnp.transpose(dg, (2, 0, 1))
        z4 = pack(al, g, K(x), theta(x), Z(x), A, D)
        return pack_matter_mhd(
            z4, rho(x), v_low(x), p(x), B_up(x), gamma=GAMMA,
            psi_glm=psi(x),
        )

    return state


def _oracle_full_rhs(fields, *, slicing, f, m, kappa1, kappa2, c_h,
                     glm_kappa):
    """Independent FULL time derivative of all 47 components.

    Construction (everything from first principles — no module algebra):
    the 4-metric (zero shift), u^μ, the fluid-frame field b^μ, the total
    T^{μν} = (ρh + b²)u^μu^ν + (p + b²/2)g^{μν} − b^μb^ν, and the dual
    Faraday tensor F*^{μν} = b^μu^ν − b^νu^μ.  Conserved densities and
    their fluxes are the covariant conservation laws in coordinates:
    ∂_t(√−g T^{0ν}-contractions) + ∂_d(√−g T^{dν}-contractions) = sources
    with √−g = α√γ, and ∂_t B̃^i = −∂_d[α√γ F*^{id}] (homogeneous
    Maxwell) + the GLM coupling.  Every spatial divergence comes from
    ``jax.jacfwd`` of the flux-as-a-function-of-x; the Z4 sector rides
    the (autodiff-geometry) oracle of ``test_z4_matter`` fed the TOTAL
    projections through its ``matter_fn`` hook — so all magnetic-sector ×
    dynamic-metric cross terms are independently covered."""
    from tests.test_z4_matter import _oracle_rhs

    alpha, gam, K, theta, Z, rho_f, p_f, v_f, B_f, psi_f = fields

    def prim(x):
        g = gam(x)
        gi = jnp.linalg.inv(g)
        vl = v_f(x)
        vup = gi @ vl
        W = 1.0 / jnp.sqrt(1.0 - vl @ vup)
        return alpha(x), g, gi, vl, vup, W, B_f(x), vl @ B_f(x)

    def g4(x):
        al = alpha(x)
        g = gam(x)
        top = jnp.concatenate([-(al * al)[None], jnp.zeros(3)])
        rows = jnp.concatenate([jnp.zeros((3, 1)), g], axis=1)
        return jnp.concatenate([top[None], rows], axis=0)

    def u4(x):
        al, g, gi, vl, vup, W, B, vB = prim(x)
        return jnp.concatenate([(W / al)[None], W * vup])

    def b4(x):
        al, g, gi, vl, vup, W, B, vB = prim(x)
        return jnp.concatenate(
            [(W * vB / al)[None], B / W + (W * vB) * vup]
        )

    def T4(x):
        """Contravariant total stress-energy."""
        al, g, gi, vl, vup, W, B, vB = prim(x)
        u = u4(x)
        b = b4(x)
        G4 = g4(x)
        b2 = b @ G4 @ b
        rho, p = rho_f(x), p_f(x)
        h = 1.0 + GAMMA / (GAMMA - 1.0) * p / rho
        return (
            (rho * h + b2) * jnp.outer(u, u)
            + (p + 0.5 * b2) * jnp.linalg.inv(G4)
            - jnp.outer(b, b)
        )

    def matter_fn(x):
        """Total (E, S_i, S_ij, tr S) by normal/projector contraction."""
        al, g, gi, vl, vup, W, B, vB = prim(x)
        T = T4(x)
        Tmix = T @ g4(x)  # T^μ_ν
        E = al * al * T[0, 0]
        S_low = al * Tmix[0, 1:]
        S_ij = g @ T[1:, 1:] @ g
        return E, S_low, S_ij, jnp.einsum("ij,ij->", gi, S_ij)

    z4_oracle = _oracle_rhs(
        alpha, gam, K, theta, Z, rho_f, p_f, v_f,
        slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
        matter_fn=matter_fn,
    )

    def fluxes(x):
        """[3, 9] — flux along d of (D̃, S̃_j, τ̃, B̃^i, φ̃)."""
        al, g, gi, vl, vup, W, B, vB = prim(x)
        sg = jnp.sqrt(jnp.linalg.det(g))
        T = T4(x)
        Tmix = T @ g4(x)
        u = u4(x)
        b = b4(x)
        F_D = al * sg * rho_f(x) * u[1:]                 # √−g ρ u^d
        F_S = al * sg * Tmix[1:, 1:]                     # √−g T^d_j
        F_tau = sg * al * al * T[0, 1:] - F_D            # √γ α(αT^{0d}) − F_D
        F_B = al * sg * (
            jnp.outer(u[1:], b[1:]) - jnp.outer(b[1:], u[1:])
        ) + al * psi_f(x) * jnp.eye(3)                   # [d, i] = α√γ F*^{id} + GLM
        F_psi = al * c_h * c_h * sg * B
        return jnp.concatenate(
            [F_D[:, None], F_S, F_tau[:, None], F_B, F_psi[:, None]],
            axis=1,
        )

    def rhs(x):
        zrows = z4_oracle(x)  # [43]: z4(38) + [0, s_S(3), s_tau]
        J = jax.jacfwd(fluxes)(x)  # [3, 9, 3]
        div = sum(J[d, :, d] for d in range(3))  # [9]
        src = jnp.concatenate(
            [
                jnp.zeros(1),
                zrows[N_Z4 + 1: N_Z4 + 4],
                zrows[N_Z4 + 4][None],
                jnp.zeros(3),
                (-glm_kappa * alpha(x) * psi_f(x))[None],
            ]
        )
        return jnp.concatenate([zrows[:N_Z4], src - div])

    return rhs


@pytest.mark.parametrize(
    "slicing,f,kappa1,kappa2,glm_kappa",
    [("harmonic", 1.0, 0.0, 0.0, 0.0), ("1+log", 1.0, 0.2, 0.1, 0.5)],
)
def test_full_rhs_matches_autodiff_oracle(slicing, f, kappa1, kappa2,
                                          glm_kappa):
    """Every one of the 47 coupled RHS components — INCLUDING the flux
    divergence, so the densitized induction and GLM on the evolving
    γ_ij/α are covered — equals the independent covariant-4-tensor +
    autodiff-geometry oracle on random smooth fields."""
    m, c_h = 2.0, 1.2
    fields = _make_mhd_fields(seed=3)
    state = _mhd_state(*fields)
    oracle = _oracle_full_rhs(
        fields, slicing=slicing, f=f, m=m, kappa1=kappa1, kappa2=kappa2,
        c_h=c_h, glm_kappa=glm_kappa,
    )
    rng = np.random.default_rng(7)
    pts = jnp.asarray(rng.uniform(0.0, 1.0, size=(5, 3)))

    kw = dict(gamma=GAMMA, iters=30, slicing=slicing, f=f, m=m,
              kappa1=kappa1, kappa2=kappa2)

    def got_fn(x):
        q = state(x)
        dq3 = jnp.swapaxes(jax.jacfwd(state)(x), -1, -2)
        ncp_src = z4_grmhd_rhs(q, dq3, glm_kappa=glm_kappa, **kw)
        J = jax.jacfwd(
            lambda y: jnp.stack(
                [
                    z4_grmhd_flux(state(y), d, var_axis=-1, gamma=GAMMA,
                                  iters=30, c_h=c_h)
                    for d in range(3)
                ]
            )
        )(x)  # [3, 47, 3]
        div = sum(J[d, :, d] for d in range(3))
        return ncp_src - div

    got = jax.vmap(got_fn)(pts)
    want = jax.vmap(oracle)(pts)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=0, atol=5e-9
    )


# --------------------------------------------------- recovery round-trip


def test_recover_round_trips_curved_primitives():
    z4, rho, v_low, p, B_up = _rng_fields()
    Q = np.asarray(pack_matter_mhd(z4, rho, v_low, p, B_up, gamma=GAMMA))
    r2, v2, p2, W2, vB2, sqg, gi = recover(jnp.asarray(Q), gamma=GAMMA)
    np.testing.assert_allclose(np.asarray(r2), rho, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(p2), p, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(v2), v_low, rtol=1e-8,
                               atol=1e-10)


# ------------------------------------------- independent 4-tensor oracle


def test_stress_energy_matches_4tensor_construction():
    """E, S_i, S_ij from the module's 3+1 closed forms vs the covariant
    T^{μν} contracted with n_μ = (−α, 0) and the spatial projector —
    independently derived from (ρ, v, p, B) and the 4-metric."""
    z4, rho, v_low, p, B_up = _rng_fields()
    Q = jnp.asarray(
        np.asarray(pack_matter_mhd(z4, rho, v_low, p, B_up, gamma=GAMMA))
    )
    E, S_low, S_ij, S_tr = (np.asarray(x) for x in
                            stress_energy(Q, gamma=GAMMA))

    # Independent construction.
    alpha = z4[:, 0]
    sym = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    g3 = np.zeros((len(rho), 3, 3))
    for s, (i, j) in enumerate(sym):
        g3[:, i, j] = g3[:, j, i] = z4[:, 1 + s]
    gi3 = np.linalg.inv(g3)
    # 4-metric (zero shift): g_00 = −α², g_ij = γ_ij.
    g4 = np.zeros((len(rho), 4, 4))
    g4[:, 0, 0] = -alpha**2
    g4[:, 1:, 1:] = g3
    g4_inv = np.zeros_like(g4)
    g4_inv[:, 0, 0] = -1.0 / alpha**2
    g4_inv[:, 1:, 1:] = gi3
    v_up = np.einsum("nij,nj->ni", gi3, v_low)
    v2 = np.einsum("ni,ni->n", v_low, v_up)
    W = 1.0 / np.sqrt(1.0 - v2)
    u_up = np.zeros((len(rho), 4))
    u_up[:, 0] = W / alpha
    u_up[:, 1:] = W[:, None] * v_up
    Bv = np.einsum("ni,ni->n", v_low, B_up)
    b_up4 = np.zeros((len(rho), 4))
    b_up4[:, 0] = W * Bv / alpha
    b_up4[:, 1:] = B_up / W[:, None] + (W * Bv)[:, None] * v_up
    b_low4 = np.einsum("nmv,nv->nm", g4, b_up4)
    b2 = np.einsum("nm,nm->n", b_up4, b_low4)
    eps = p / ((GAMMA - 1.0) * rho)
    h = 1.0 + eps + p / rho
    wtot = rho * h + b2
    ptot = p + 0.5 * b2
    T = (
        wtot[:, None, None] * np.einsum("nm,nv->nmv", u_up, u_up)
        + ptot[:, None, None] * g4_inv
        - np.einsum("nm,nv->nmv", b_up4, b_up4)
    )
    E_ind = alpha**2 * T[:, 0, 0]
    S_ind = alpha[:, None] * np.einsum("nj,nij->ni", T[:, 0, 1:], g3)
    S_ij_ind = np.einsum(
        "nkl,nik,njl->nij", T[:, 1:, 1:], g3, g3
    )
    S_tr_ind = np.einsum("nij,nij->n", gi3, S_ij_ind)
    np.testing.assert_allclose(E, E_ind, rtol=1e-9)
    np.testing.assert_allclose(S_low, S_ind, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(S_ij, S_ij_ind, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(S_tr, S_tr_ind, rtol=1e-8, atol=1e-11)


# ------------------------------------------------------ exact reductions


def test_zero_field_reduces_to_coupled_hydro():
    """B = 0, φ̃ = 0: RHS and flux rows equal `z4_matter` (which is
    autodiff-oracle validated) to recovery-convergence level."""
    from exahype_jax.models import z4_matter

    z4, rho, v_low, p, _ = _rng_fields()
    B0 = np.zeros((len(rho), 3))
    Qm = np.asarray(
        pack_matter_mhd(z4, rho, v_low, p, B0, gamma=GAMMA)
    )
    Qh = np.asarray(
        z4_matter.pack_matter(z4, rho, v_low, p, gamma=GAMMA)
    )
    np.testing.assert_allclose(Qm[:, :43], Qh, rtol=1e-12, atol=1e-14)
    dq3 = np.random.default_rng(5).uniform(-0.1, 0.1, (len(rho), 3, N_VARS))
    r_m = np.asarray(z4_grmhd_rhs(jnp.asarray(Qm), jnp.asarray(dq3),
                                  gamma=GAMMA))
    r_h = np.asarray(
        z4_matter.z4_matter_rhs(
            jnp.asarray(Qh), jnp.asarray(dq3[..., :43]), gamma=GAMMA
        )
    )
    np.testing.assert_allclose(r_m[:, :43], r_h, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(r_m[:, 43:], 0.0, atol=1e-12)
    for ax in range(3):
        f_m = np.asarray(
            z4_grmhd_flux(jnp.asarray(Qm), ax, -1, gamma=GAMMA)
        )
        f_h = np.asarray(
            z4_matter.z4_matter_flux(jnp.asarray(Qh), ax, -1, gamma=GAMMA)
        )
        np.testing.assert_allclose(f_m[:, :43], f_h, rtol=1e-7,
                                   atol=1e-10)


def test_flat_frozen_metric_flux_reduces_to_rmhd():
    """α = 1, γ = δ: the hydro+B+GLM flux rows equal flat `rmhd` and the
    hydro geometric sources vanish."""
    z4, rho, v_low, p, B_up = _rng_fields(curved=False)
    rng = np.random.default_rng(11)
    psi = rng.uniform(-0.2, 0.2, len(rho))
    z4[:, 0] = 1.0
    Q = np.asarray(
        pack_matter_mhd(z4, rho, v_low, p, B_up, gamma=GAMMA,
                        psi_glm=psi)
    )
    Q_rmhd = np.array(
        rmhd.prim_to_cons(rho, v_low, p, B_up, gamma=GAMMA)
    )
    Q_rmhd[:, 8] = psi
    np.testing.assert_allclose(Q[:, 38:], Q_rmhd, rtol=1e-12, atol=1e-13)
    for ax in range(3):
        f = np.asarray(z4_grmhd_flux(jnp.asarray(Q), ax, -1, gamma=GAMMA,
                                     c_h=1.0))
        f_r = np.asarray(
            rmhd.rmhd_flux(jnp.asarray(Q_rmhd), ax, gamma=GAMMA, c_h=1.0)
        )
        np.testing.assert_allclose(f[:, 38:], f_r, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(f[:, :38], 0.0, atol=1e-14)
    # Flat static geometry: hydro/B source rows vanish; the Z4 curvature
    # sector still feels the matter (Einstein's equations are not
    # satisfied by flat space + matter — that is physics, not a bug).
    zeros = jnp.zeros((len(rho), 3, N_VARS))
    r = np.asarray(z4_grmhd_rhs(jnp.asarray(Q), zeros, gamma=GAMMA))
    np.testing.assert_allclose(r[:, 38:], 0.0, atol=1e-12)


def test_soa_rhs_matches_einsum_rhs():
    z4, rho, v_low, p, B_up = _rng_fields(seed=7)
    Q = jnp.asarray(
        np.asarray(pack_matter_mhd(z4, rho, v_low, p, B_up, gamma=GAMMA))
    )
    dq3 = jnp.asarray(
        np.random.default_rng(9).uniform(-0.1, 0.1, (len(rho), 3, N_VARS))
    )
    kw = dict(gamma=GAMMA, slicing="harmonic", f=0.73, m=1.4,
              kappa1=0.21, kappa2=0.05, glm_kappa=0.3)
    a = np.asarray(z4_grmhd_rhs(Q, dq3, **kw))
    b = np.asarray(z4_grmhd_rhs_soa(Q, dq3, **kw))
    np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-11)


# --------------------------------------------------------- solver level


def _magnetized_wave_state(solver, B0=0.05, amp=0.05):
    """Smooth periodic magnetized state on a weakly-curved slice."""
    coords = solver.nodes_meshgrid()
    no_var = tuple(
        s for e, s in enumerate(solver.state_shape)
        if e != solver.var_axis
    )
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), solver.var_axis), no_var
    )
    shape = x.shape
    z4 = np.zeros(shape + (N_Z4,))
    z4[..., 0] = 1.0
    pert = amp * np.sin(2 * np.pi * x)
    z4[..., 1] = 1.0 + pert  # γ_xx
    z4[..., 4] = z4[..., 6] = 1.0
    z4[..., 20] = 0.5 * amp * 2 * np.pi * np.cos(2 * np.pi * x)  # D_xxx
    rho = 1.0 + 0.1 * np.sin(2 * np.pi * x)
    p = 1.0 + 0.05 * np.cos(2 * np.pi * x)
    v = np.zeros(shape + (3,))
    v[..., 1] = 0.1 * np.sin(2 * np.pi * x)
    B = np.zeros(shape + (3,))
    B[..., 0] = B0                    # uniform B̃-compatible seed
    B[..., 2] = 0.3 * B0 * np.cos(2 * np.pi * x)
    Q = pack_matter_mhd(z4, rho, v, p, B, gamma=GAMMA)
    return jnp.moveaxis(jnp.asarray(Q), -1, solver.var_axis)


@pytest.mark.slow
def test_coupled_step_finite_and_flux_sectors_conserve():
    """One-axis-varying magnetized state: D̃ and B̃ (pure flux form) are
    conserved to rounding through periodic ADER-DG steps; the state stays
    finite and admissible."""
    solver = make_z4_grmhd_solver(
        dim=2, order=2, grid_shape=(8, 4), dx=0.125, gamma=GAMMA,
        slicing="harmonic", f=1.0, glm_kappa=0.5,
    )
    Q = _magnetized_wave_state(solver)
    adm = z4_grmhd_admissible(gamma=GAMMA)
    assert bool(np.asarray(adm(Q, solver.var_axis)).all())
    out = solver.run(Q, 5, 5e-4)
    on = np.asarray(out)
    assert np.isfinite(on).all()
    assert bool(np.asarray(adm(out, solver.var_axis)).all())
    w = np.asarray(solver.ops.weights)
    wq = np.einsum("i,j->ij", w, w).reshape(
        (solver.n_nodes,) * 2 + (1,) * (len(solver.state_shape) - 2)
    )
    for var in (38, 43, 44, 45):  # D̃, B̃^i
        q0 = np.asarray(jnp.take(Q, var, solver.var_axis))
        q1 = np.asarray(jnp.take(out, var, solver.var_axis))
        tot0 = float((wq.reshape(wq.shape[:2] + (1, 1)) * q0).sum())
        tot1 = float((wq.reshape(wq.shape[:2] + (1, 1)) * q1).sum())
        assert abs(tot1 - tot0) < 1e-10 * (1.0 + abs(tot0)), (var, tot0,
                                                              tot1)


@pytest.mark.slow
def test_glm_keeps_divergence_bounded():
    """Seed a div-B̃ violation on a flat frozen slice: with GLM cleaning
    the flat divergence decays instead of growing."""
    solver = make_z4_grmhd_solver(
        dim=2, order=2, grid_shape=(8, 8), dx=0.125, gamma=GAMMA,
        slicing="harmonic", f=0.0, c_h=1.0, glm_kappa=2.0,
    )
    coords = solver.nodes_meshgrid()
    no_var = tuple(
        s for e, s in enumerate(solver.state_shape)
        if e != solver.var_axis
    )
    x = np.broadcast_to(
        np.squeeze(np.asarray(coords[0]), solver.var_axis), no_var
    )
    y = np.broadcast_to(
        np.squeeze(np.asarray(coords[1]), solver.var_axis), no_var
    )
    z4 = np.zeros(x.shape + (N_Z4,))
    z4[..., 0] = 1.0
    z4[..., 1] = z4[..., 4] = z4[..., 6] = 1.0
    rho = np.ones_like(x)
    p = np.ones_like(x)
    v = np.zeros(x.shape + (3,))
    B = np.zeros(x.shape + (3,))
    # Monopole-ish violation: B_x = a·sin(2πx)·cos(2πy) alone has
    # ∂_x B_x ≠ 0.
    B[..., 0] = 0.1 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y)
    Q = jnp.moveaxis(
        jnp.asarray(pack_matter_mhd(z4, rho, v, p, B, gamma=GAMMA)),
        -1, solver.var_axis,
    )

    def divB_l2(u):
        q = jnp.moveaxis(u, solver.var_axis, -1)
        Bx = q[..., 43]
        By = q[..., 44]
        from exahype_jax.models.aderdg import _apply

        dBx = _apply(np.asarray(solver.ops.D), Bx,
                     axis=solver.node_axis(0)) / solver._dxs[0]
        dBy = _apply(np.asarray(solver.ops.D), By,
                     axis=solver.node_axis(1) - 1
                     if solver.node_axis(1) > solver.var_axis
                     else solver.node_axis(1)) / solver._dxs[1]
        return float(jnp.sqrt(jnp.mean((dBx + dBy) ** 2)))

    d0 = divB_l2(Q)
    out = solver.run(Q, 40, 2e-3)
    d1 = divB_l2(out)
    assert np.isfinite(np.asarray(out)).all()
    assert d1 < 0.9 * d0, (d0, d1)


@pytest.mark.slow
def test_limiter_composes_with_coupled_mhd():
    from exahype_jax.models.limiter import LimitedADERDG

    solver = make_z4_grmhd_solver(
        dim=2, order=2, grid_shape=(6, 6), dx=1.0 / 6, gamma=GAMMA,
        slicing="harmonic", f=0.0,
    )
    limited = LimitedADERDG(solver, admissible=z4_grmhd_admissible(GAMMA))
    Q = _magnetized_wave_state(solver)
    coords = solver.nodes_meshgrid()
    x = jnp.squeeze(jnp.asarray(coords[0]), solver.var_axis)
    y = jnp.squeeze(jnp.asarray(coords[1]), solver.var_axis)
    bump = 1.0 + 4.0 * jnp.exp(
        -(((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.01)
    )
    q = jnp.moveaxis(Q, solver.var_axis, -1)
    q = q.at[..., 38].mul(bump)
    q = q.at[..., 42].mul(bump)
    Q = jnp.moveaxis(q, -1, solver.var_axis)
    adm = z4_grmhd_admissible(GAMMA)
    assert bool(np.asarray(adm(Q, solver.var_axis)).all())
    out = Q
    for _ in range(3):
        out = limited.step(out, 1e-3)
    assert np.isfinite(np.asarray(out)).all()
    assert bool(np.asarray(adm(out, solver.var_axis)).all())
    cand = solver.step(Q, 1e-3)
    assert int(np.asarray(limited.troubled_mask(Q, cand)).sum()) > 0


@pytest.mark.slow
def test_sharded_coupled_mhd_matches_single_device():
    from jax.sharding import NamedSharding, PartitionSpec

    from exahype_jax.parallel import make_mesh

    solver = make_z4_grmhd_solver(
        dim=2, order=2, grid_shape=(8, 4), dx=0.25, gamma=GAMMA,
        slicing="harmonic", f=0.0,
    )
    Q = _magnetized_wave_state(solver)
    want = np.asarray(solver.step(Q, 5e-4))
    mesh = make_mesh(2)
    spec = [None] * len(solver.state_shape)
    spec[solver.grid_axis(0)] = "patches"
    sharding = NamedSharding(mesh, PartitionSpec(*spec))
    Qs = jax.device_put(Q, sharding)
    got = np.asarray(
        jax.jit(lambda u: solver.step(u, 5e-4),
                in_shardings=(sharding,), out_shardings=sharding)(Qs)
    )
    np.testing.assert_allclose(got, want, atol=5e-12)


@pytest.mark.slow
def test_fused_rhs_hook_matches_plain_step():
    """``fused_rhs='soa'`` (the one-evaluation SoA hook) is a
    pure refactor of the Picard RHS: one coupled step matches the plain
    per-axis solver to rounding — for BOTH coupled systems."""
    from exahype_jax.models.z4_matter import make_z4_matter_solver

    solver = make_z4_grmhd_solver(
        dim=2, order=2, grid_shape=(4, 4), dx=0.25, gamma=GAMMA,
    )
    fused = make_z4_grmhd_solver(
        dim=2, order=2, grid_shape=(4, 4), dx=0.25, gamma=GAMMA,
        impl="soa", fused_rhs="soa",
    )
    Q = _magnetized_wave_state(solver)
    a = np.asarray(solver.step(Q, 5e-4))
    b = np.asarray(fused.step(Q, 5e-4))
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)

    from exahype_jax.models.z4_matter import flrw_state

    hs = make_z4_matter_solver(dim=2, order=2, grid_shape=(4, 4), dx=0.25,
                               gamma=GAMMA, slicing="harmonic", f=0.0)
    hf = make_z4_matter_solver(dim=2, order=2, grid_shape=(4, 4), dx=0.25,
                               gamma=GAMMA, slicing="harmonic", f=0.0,
                               impl="soa", fused_rhs="soa")
    rho0 = 0.02
    Qh = flrw_state(hs, 1.0, float(np.sqrt(8 * np.pi * rho0 / 3)),
                    rho0=rho0, gamma=GAMMA)
    qh = jnp.moveaxis(Qh, hs.var_axis, -1)
    x = np.linspace(0, 1, qh.shape[-2], endpoint=False)
    qh = qh.at[..., 38].mul(
        jnp.asarray(1.0 + 0.05 * np.sin(2 * np.pi * x))[:, None]
    )
    Qh = jnp.moveaxis(qh, -1, hs.var_axis)
    a = np.asarray(hs.step(Qh, 5e-4))
    b = np.asarray(hf.step(Qh, 5e-4))
    np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11)
