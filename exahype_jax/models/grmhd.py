"""GRMHD in a static background spacetime (Cowling approximation),
lapse-only metric — the ExaHyPE astrophysics headline system.

Composes `models/grhd.py`'s geometry (static lapse α(x), flat slices,
zero shift; metric carried as frozen variables) with `models/rmhd.py`'s
magnetized physics (Valencia variables, AD-Newton con2prim, GLM
cleaning).  With β = 0 and √γ = 1 the equations are the RMHD ones with
lapse-scaled fluxes plus two geometric sources:

    ∂t U + ∂_i (α F^i_RMHD) = s,
    s(S_j) = −(τ + D) ∂_j α          (α² T⁰⁰ = τ + D, incl. field energy)
    s(τ)   = −S^j ∂_j α
    s(D) = s(B) = s(ψ) = 0           (induction is source-free for β = 0)

State: ``[D, S_x..z, τ, B_x..z, ψ, α, ∂_1α..∂_dimα]`` (12 vars in 2-D).

Exact anchors (tested): α ≡ 1 reduces to the independent `rmhd` module;
a UNIFORM magnetic field shifts the Tolman equilibrium by a constant —
the flux carries magnetic pressure and the source carries field energy,
so αp' = −(ρh + B²)α' and with ρh = kp the exact magnetized profile is
p = p₀α^{−k} − B²/k (B bitwise frozen, residual converging at the
scheme's order); coordinate causality λ ≤ α.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from exahype_jax.models import rmhd

N_HYDRO = rmhd.N_VARS  # 9: D, S(3), tau, B(3), psi


def n_vars(dim: int) -> int:
    return N_HYDRO + 1 + dim


def pack_state(rho, v, p, B, alpha, dalpha, *, gamma: float = 5.0 / 3.0):
    """Primitives + metric → the full var-last GRMHD state."""
    hydro = rmhd.prim_to_cons(rho, v, p, B, gamma=gamma)
    alpha = jnp.broadcast_to(jnp.asarray(alpha), hydro.shape[:-1])
    return jnp.concatenate(
        [hydro, alpha[..., None], jnp.asarray(dalpha)], axis=-1
    )


def grmhd_flux(Q, normal, *, dim: int = 2, gamma: float = 5.0 / 3.0,
               c_h: float = 1.0, iters: int = 20):
    hydro = Q[..., :N_HYDRO]
    alpha = Q[..., N_HYDRO]
    f = alpha[..., None] * rmhd.rmhd_flux(
        hydro, normal, gamma=gamma, c_h=c_h, iters=iters
    )
    zeros = jnp.zeros(Q.shape[:-1] + (1 + dim,), Q.dtype)
    return jnp.concatenate([f, zeros], axis=-1)


def grmhd_eigenvalue(Q, normal, *, dim: int = 2, gamma: float = 5.0 / 3.0,
                     c_h: float = 1.0, iters: int = 20):
    return Q[..., N_HYDRO] * rmhd.rmhd_eigenvalue(
        Q[..., :N_HYDRO], normal, gamma=gamma, c_h=c_h, iters=iters
    )


def grmhd(dim: int = 2, gamma: float = 5.0 / 3.0, c_h: float = 1.0,
          iters: int = 20):
    """(flux, max_eigenvalue) batch-native pair."""
    return (
        partial(grmhd_flux, dim=dim, gamma=gamma, c_h=c_h, iters=iters),
        partial(grmhd_eigenvalue, dim=dim, gamma=gamma, c_h=c_h,
                iters=iters),
    )


def grmhd_source(dim: int = 2):
    """Geometric sources in the ``ADERDGSolver.source_fn`` contract."""

    def source(q, var_axis):
        def pick(k):
            return jax.lax.index_in_dim(q, k, var_axis, keepdims=False)

        D = pick(0)
        tau = pick(4)
        E = tau + D
        zero = jnp.zeros_like(D)
        sS = []
        s_dot_da = zero
        for d in range(dim):
            da = pick(N_HYDRO + 1 + d)
            sS.append(-E * da)
            s_dot_da = s_dot_da + pick(1 + d) * da
        # S carries 3 components; out-of-plane momenta see no ∂α.
        while len(sS) < 3:
            sS.append(zero)
        parts = (
            [zero] + sS + [-s_dot_da]
            + [zero] * 4                     # B(3), ψ
            + [zero] * (1 + dim)             # α, ∂α
        )
        return jnp.stack(parts, axis=var_axis)

    return source


def grmhd_dissipation_mask(dim: int = 2) -> tuple:
    """Freeze the metric slots against Rusanov smearing."""
    return (1.0,) * N_HYDRO + (0.0,) * (1 + dim)


def grmhd_admissible(dim: int = 2, gamma: float = 5.0 / 3.0,
                     iters: int = 20):
    """Limiter hook: magnetized recovery admissible + positive lapse."""
    hydro_ok = rmhd.rmhd_admissible(gamma=gamma, iters=iters)

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        return hydro_ok(q[..., :N_HYDRO], q.ndim - 1) & (
            q[..., N_HYDRO] > 0
        )

    return ok
