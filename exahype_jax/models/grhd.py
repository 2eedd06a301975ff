"""GRHD in a static background spacetime (Cowling approximation),
lapse-only metric — the first general-relativistic rung of the
astrophysics family.

Metric ``ds² = −α(x)² dt² + δ_ij dx^i dx^j`` (static lapse, flat spatial
slices, zero shift): the Valencia equations reduce to

    ∂t D   + ∂_i (α D v^i)              = 0
    ∂t S_j + ∂_i (α [S_j v^i + p δ^i_j]) = −(τ + D) ∂_j α
    ∂t τ   + ∂_i (α [τ + p] v^i)         = −S^j ∂_j α

i.e. exactly the SRHD fluxes scaled by the lapse plus geometric sources.
The design is the heterogeneous-elasticity pattern: the metric rides the
state as FROZEN variables — ``Q = [D, S_1..dim, τ, α, ∂_1α..∂_dimα]`` —
with zero flux rows and zero sources, so the same jitted step serves any
background and the sources need no gradient evaluation of a field (the
analytic ∂α is data).  con2prim is the flat-space SRHD recovery applied
to the hydro block (spatial slices are flat), so all of its guarantees
(fixed-trip bracketed Newton, causal clamps) carry over.

Exact validation targets (tested):

- ``α ≡ 1`` reduces bitwise-close to the independent `srhd` module;
- the Tolman hydrostatic equilibrium ``α ∂_j p = −ρh ∂_j α`` has the
  closed-form solution ``p = p₀ α^{−k}`` with ``k = 1/c² + γ/(γ−1)``
  for the isothermal-like ρ = p/c² — the discrete residual converges at
  the scheme's order on a smooth periodic lapse;
- D is exactly conserved (its source vanishes); λ ≤ α (coordinate light
  cone).

Citation: the reference repo has no GR capability (SURVEY.md §0); the
ExaHyPE application papers' GRMHD solvers are the family this targets.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

from exahype_jax.models import srhd
from exahype_jax.utils.errors import SemanticError


def n_vars(dim: int) -> int:
    """[D, S_1..dim, τ, α, ∂α_1..dim]."""
    return (dim + 2) + 1 + dim


def pack_state(rho, v, p, alpha, dalpha, *, gamma: float = 5.0 / 3.0):
    """Primitives + metric → the full var-last GRHD state."""
    hydro = srhd.prim_to_cons(rho, v, p, gamma=gamma)
    alpha = jnp.broadcast_to(jnp.asarray(alpha), hydro.shape[:-1])
    dalpha = jnp.asarray(dalpha)
    return jnp.concatenate([hydro, alpha[..., None], dalpha], axis=-1)


def grhd_flux(Q, normal, *, dim: int = 2, gamma: float = 5.0 / 3.0,
              iters: int = 10):
    nh = dim + 2
    hydro = Q[..., :nh]
    alpha = Q[..., nh]
    f = srhd.srhd_flux(hydro, normal, gamma=gamma, iters=iters)
    f = alpha[..., None] * f
    zeros = jnp.zeros(Q.shape[:-1] + (1 + dim,), Q.dtype)
    return jnp.concatenate([f, zeros], axis=-1)


def grhd_eigenvalue(Q, normal, *, dim: int = 2, gamma: float = 5.0 / 3.0,
                    iters: int = 10):
    nh = dim + 2
    return Q[..., nh] * srhd.srhd_eigenvalue(
        Q[..., :nh], normal, gamma=gamma, iters=iters
    )


def grhd(dim: int = 2, gamma: float = 5.0 / 3.0, iters: int = 10):
    """(flux, max_eigenvalue) batch-native pair."""
    return (
        partial(grhd_flux, dim=dim, gamma=gamma, iters=iters),
        partial(grhd_eigenvalue, dim=dim, gamma=gamma, iters=iters),
    )


def grhd_source(dim: int = 2):
    """Geometric sources, in the ``ADERDGSolver.source_fn(q, var_axis)``
    contract: s(S_j) = −(τ+D)∂_jα, s(τ) = −S^j∂_jα; D and the metric
    slots are source-free."""
    import jax

    nh = dim + 2

    def source(q, var_axis):
        def pick(k):
            return jax.lax.index_in_dim(q, k, var_axis, keepdims=False)

        D = pick(0)
        tau = pick(nh - 1)
        E = tau + D
        parts = [jnp.zeros_like(D)]
        s_dot_da = jnp.zeros_like(D)
        for d in range(dim):
            da = pick(nh + 1 + d)
            parts.append(-E * da)
            s_dot_da = s_dot_da + pick(1 + d) * da
        parts.append(-s_dot_da)
        parts.extend(jnp.zeros_like(D) for _ in range(1 + dim))
        return jnp.stack(parts, axis=var_axis)

    return source


def grhd_dissipation_mask(dim: int = 2) -> tuple:
    """Freeze the metric slots against Rusanov smearing (their central
    flux is already zero)."""
    return (1.0,) * (dim + 2) + (0.0,) * (1 + dim)


def hydrostatic_exponent(c2: float, gamma: float = 5.0 / 3.0) -> float:
    """k in the exact Tolman equilibrium p = p₀ α^{−k} for ρ = p/c²."""
    return 1.0 / c2 + gamma / (gamma - 1.0)


def grhd_admissible(dim: int = 2, gamma: float = 5.0 / 3.0,
                    iters: int = 10):
    """Limiter admissibility on the hydro block (positive recovery,
    subluminal), plus a positive lapse."""
    nh = dim + 2

    def ok(Q, var_axis):
        q = jnp.moveaxis(Q, var_axis, -1)
        hydro = q[..., :nh]
        rho, v, p, W = srhd.con2prim(hydro, gamma=gamma, iters=iters)
        v2 = jnp.sum(v * v, axis=-1)
        fin = jnp.all(jnp.isfinite(q), axis=-1)
        return fin & (rho > 0) & (p > 0) & (v2 < 1.0) & (q[..., nh] > 0)

    return ok
