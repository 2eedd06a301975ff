"""Michel (1972) spherical accretion onto a Schwarzschild black hole —
the canonical exact stationary GR-hydro validation, in the ISOTROPIC
coordinates the CFC solver (`models/grhd_cfc.py`) evolves.

Construction (polytropic EOS p = Kρ^Γ, K = 1):

1. Pick the critical (sonic) areal radius R_c.  Regularity there fixes
   u_c² = M/(2R_c) and a_c² = u_c²/(1 − 3u_c²) (a = relativistic sound
   speed), hence ρ_c from a² = ΓKρ^{Γ−1}/h.
2. Two exact integrals hold along the flow:
   mass flux  C1 = R² ρ u   and   Bernoulli  C2 = h²(1 − 2M/R + u²),
   with u ≡ |u^R| the areal radial 4-velocity component.  For any R the
   state follows from a bracketed bisection on ρ (the SUBSONIC branch
   outside R_c — the one a window at R > R_c needs).
3. Transform to isotropic r (R = r(1+M/2r)², dR/dr = αψ² exactly):
   u^r = u^R/(αψ²),  W = √(1 + ψ⁴ (u^r)²),  Valencia v^r = u^r/W
   (zero shift), directed radially inward.

`michel_solution(r, ...)` returns var-last primitives on isotropic
radii; `michel_state(x..., center, ...)` packs the full `grhd_cfc`
state on a Cartesian window.  Both are NumPy (boundary/initial data
construction).  The integrals themselves are machine-checked in
``tests/test_models.py`` (constancy of C1, C2 on the returned data) and
the window test checks stationarity under the actual solver — a wrong
construction would NOT converge, so the oracle is self-validating.
"""

from __future__ import annotations

import numpy as np


def _enthalpy(rho, Gamma, K=1.0):
    return 1.0 + Gamma / (Gamma - 1.0) * K * rho ** (Gamma - 1.0)


def michel_constants(R_c: float, Gamma: float = 4.0 / 3.0, M: float = 1.0,
                     K: float = 1.0):
    """(C1, C2, rho_c, u_c) from the critical-point conditions."""
    u_c2 = M / (2.0 * R_c)
    if not 0.0 < u_c2 < 1.0 / 3.0:
        raise ValueError("critical radius must satisfy R_c > 3M/2")
    a_c2 = u_c2 / (1.0 - 3.0 * u_c2)
    # a² = Γ K ρ^{Γ−1} / h  ⇒  y ≡ K ρ^{Γ−1} = a²/(Γ(1 − a²/(Γ−1)))
    y = a_c2 / (Gamma * (1.0 - a_c2 / (Gamma - 1.0)))
    if y <= 0:
        raise ValueError("critical sound speed exceeds the EOS limit")
    rho_c = (y / K) ** (1.0 / (Gamma - 1.0))
    u_c = np.sqrt(u_c2)
    C1 = R_c * R_c * rho_c * u_c
    C2 = _enthalpy(rho_c, Gamma, K) ** 2 * (1.0 - 2.0 * M / R_c + u_c2)
    return C1, C2, rho_c, u_c


def michel_areal(R, R_c: float, Gamma: float = 4.0 / 3.0, M: float = 1.0,
                 K: float = 1.0, iters: int = 200):
    """(rho, u, p) on areal radii R (subsonic branch for R > R_c,
    supersonic inside), by bisection on ρ of the Bernoulli residual."""
    R = np.asarray(R, float)
    C1, C2, rho_c, _ = michel_constants(R_c, Gamma, M, K)

    def bernoulli(rho):
        u = C1 / (R * R * rho)
        return (_enthalpy(rho, Gamma, K) ** 2
                * (1.0 - 2.0 * M / R + u * u) - C2)

    # f(ρ) → +∞ at both ends with one interior minimum (the locally-sonic
    # density); the SUBSONIC root sits right of it, the supersonic left.
    # Locate the minimizer by ternary search on log ρ, then bisect the
    # wanted branch.  (At R = R_c the minimum IS the double root.)
    t_lo = np.full(R.shape, np.log(rho_c) - 40.0)
    t_hi = np.full(R.shape, np.log(rho_c) + 40.0)
    for _ in range(iters):
        m1 = t_lo + (t_hi - t_lo) / 3.0
        m2 = t_hi - (t_hi - t_lo) / 3.0
        smaller_left = bernoulli(np.exp(m1)) < bernoulli(np.exp(m2))
        t_hi = np.where(smaller_left, m2, t_hi)
        t_lo = np.where(smaller_left, t_lo, m1)
    rho_min = np.exp(0.5 * (t_lo + t_hi))

    subsonic = R >= R_c
    lo = np.where(subsonic, rho_min, 1e-18 * rho_min)
    hi = np.where(subsonic, 1e18 * rho_min, rho_min)
    flo = bernoulli(lo)
    for _ in range(iters):
        mid = np.sqrt(lo * hi)  # bisect in log space
        fm = bernoulli(mid)
        same = np.sign(fm) == np.sign(flo)
        lo = np.where(same, mid, lo)
        flo = np.where(same, fm, flo)
        hi = np.where(same, hi, mid)
    rho = np.sqrt(lo * hi)
    u = C1 / (R * R * rho)
    return rho, u, K * rho**Gamma


def areal_of_isotropic(r, M: float = 1.0):
    return r * (1.0 + M / (2.0 * r)) ** 2


def michel_isotropic(r, R_c: float, Gamma: float = 4.0 / 3.0,
                     M: float = 1.0, K: float = 1.0):
    """(rho, v_r, p, alpha, psi) on isotropic radii r: Valencia
    primitives of the inward flow (v_r < 0 is the coordinate radial
    velocity component v^r)."""
    from exahype_jax.models.grhd_cfc import schwarzschild_isotropic

    r = np.asarray(r, float)
    R = areal_of_isotropic(r, M)
    rho, u, p = michel_areal(R, R_c, Gamma, M, K)
    alpha, psi, _, _ = (np.asarray(v) for v in schwarzschild_isotropic(r, M))
    u_r = -u / (alpha * psi**2)          # dR/dr = αψ² exactly; inward
    W = np.sqrt(1.0 + psi**4 * u_r * u_r)
    return rho, u_r / W, p, alpha, psi


def michel_state(*coords, center, R_c: float, Gamma: float = 4.0 / 3.0,
                 M: float = 1.0, K: float = 1.0):
    """Full var-last `grhd_cfc` state of the Michel flow on a Cartesian
    window (any dim; radial direction from ``center``)."""
    import jax.numpy as jnp

    from exahype_jax.models import grhd_cfc

    dim = len(coords)
    rel = [np.asarray(c, float) - center[e] for e, c in enumerate(coords)]
    r = np.sqrt(sum(x * x for x in rel))
    n = [x / r for x in rel]
    rho, v_r, p, alpha, psi = michel_isotropic(r, R_c, Gamma, M, K)
    from exahype_jax.models.grhd_cfc import schwarzschild_isotropic

    _, _, dadr, dpdr = (np.asarray(v) for v in schwarzschild_isotropic(r, M))
    v = np.stack([v_r * ni for ni in n], -1)
    dalpha = np.stack([dadr * ni for ni in n], -1)
    dpsi = np.stack([dpdr * ni for ni in n], -1)
    return np.asarray(grhd_cfc.pack_state(
        jnp.asarray(rho), jnp.asarray(v), jnp.asarray(p),
        jnp.asarray(alpha), jnp.asarray(psi), jnp.asarray(dalpha),
        jnp.asarray(dpsi), gamma=Gamma,
    ))
