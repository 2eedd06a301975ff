"""TOV stars: exact and polytropic relativistic-star initial data.

The canonical strong-field stationary anchor for GR-hydro codes (VERDICT
round 3, task 1): a static, spherically symmetric self-gravitating fluid
solving the Tolman–Oppenheimer–Volkoff equations.  Any spherically
symmetric 3-metric is conformally flat, so a TOV star in ISOTROPIC
coordinates lives exactly in the :mod:`~exahype_jax.models.grhd_cfc`
geometry class (``ds² = −α²dt² + ψ⁴δdx²``) — Cowling evolution needs no
new solver — and supplies consistent first-order data (A_k = ∂_k ln α,
D_kij = ½∂_kγ_ij) for the COUPLED dynamic-spacetime system
(:mod:`~exahype_jax.models.z4_matter`).

Two construction paths:

- :func:`constant_density_star` — the interior Schwarzschild solution
  (Tolman's constant-energy-density star) in CLOSED FORM, including the
  isotropic-radius transform: with ``k² = 2M/R³``, ``s = √(1−k²r²)``,

      r̄ = C·r/(1+s)           (so r = 2(r̄/C)/(1+k²(r̄/C)²) exactly),
      ψ² = r/r̄ = (1+s)/C,     α = (3 s_R − s)/2,
      p  = ρ_E (s − s_R)/(3 s_R − s),   ρ_E = 3M/(4πR³),

  with C fixed by the exterior match ``r̄(R) = R(1+s_R)²/4``.  The
  derivative closed forms (``dr̄/dr = C/(s(1+s))`` ⇒ dψ/dr̄ =
  ψ(s−1)/(2r̄), dα/dr̄ = k²rψ²/2) make the whole star machine-checkable:
  α, ψ are C¹ at the surface and hydrostatic balance
  ``dp/dr̄ = −(ρ_E+p) ∂_r̄ ln α`` holds identically (verified to
  rounding in ``tests/test_tov.py``).  This is the oracle the numeric
  integrator is validated against.

- :func:`polytrope_star` — RK4 integration of the TOV system for a
  ``p = KρΓ`` polytrope (the production initial-data path: the classic
  K=100, Γ=2 neutron-star model), integrating ``(m, p, ln α, ln(r̄/r))``
  jointly; ``d ln(r̄/r)/dr = (1−√(1−2m/r))/(r√(1−2m/r))`` is regular at
  the centre.  Matched to the Schwarzschild exterior at the surface.

Rest-mass density under the solver's Γ-law EOS: hydrostatic equilibrium
constrains only (ρ_E, p, α) — EOS-independent — so ρ = ρ_E − p/(Γ−1)
(from ρ_E = ρ(1+ε), ε = p/((Γ−1)ρ)) yields a Γ-law fluid state that is
EXACTLY stationary for the evolution.

Reference-family context: the reference repo bundles only Euler physics
(``Unit test/Functions.cpp:9-62``); this is a family-capability module
for the ExaGRyPE programme rung, like :mod:`michel` (the stationary
ACCRETION anchor) but self-gravitating.
"""

from __future__ import annotations

import numpy as np

FOUR_PI = 4.0 * np.pi


class TOVStar:
    """A TOV solution: ``profile(r_iso)`` returns
    ``(rho_E, p, alpha, psi, dalpha_driso, dpsi_driso)`` (NumPy,
    vectorized over isotropic radii, interior + Schwarzschild exterior).

    Attributes: ``M`` (gravitational mass), ``R`` (areal surface
    radius), ``r_iso_surface`` (isotropic surface radius).
    """

    def __init__(self, M: float, R: float, profile):
        self.M = float(M)
        self.R = float(R)
        s_R = np.sqrt(1.0 - 2.0 * self.M / self.R)
        self.r_iso_surface = self.R * (1.0 + s_R) ** 2 / 4.0
        self._profile = profile

    def profile(self, r_iso):
        return self._profile(np.asarray(r_iso, float))


def _exterior(r_iso, M):
    """Schwarzschild exterior (α, ψ, dα/dr̄, dψ/dr̄) — closed form."""
    u = M / (2.0 * r_iso)
    psi = 1.0 + u
    alpha = (1.0 - u) / (1.0 + u)
    du = -M / (2.0 * r_iso * r_iso)
    dpsi = du
    dalpha = -2.0 * du / (1.0 + u) ** 2
    return alpha, psi, dalpha, dpsi


def constant_density_star(M: float = 0.15, R: float = 1.0) -> TOVStar:
    """The exact interior-Schwarzschild (constant ρ_E) star.

    Requires compactness 2M/R < 8/9 (Buchdahl).  ρ_E jumps at the
    surface (the solution's nature); α and ψ are C¹ there.
    """
    if not 2.0 * M / R < 8.0 / 9.0:
        raise ValueError("constant-density star beyond the Buchdahl bound")
    k2 = 2.0 * M / R**3
    s_R = np.sqrt(1.0 - 2.0 * M / R)
    riso_R = R * (1.0 + s_R) ** 2 / 4.0
    C = riso_R * (1.0 + s_R) / R
    rho_E = 3.0 * M / (FOUR_PI * R**3)

    def profile(ri):
        ri = np.asarray(ri, float)
        inside = ri <= riso_R
        # Interior closed forms (regular at r̄ = 0: ratio and r are
        # computed without dividing by r̄).
        y = ri / C
        r = 2.0 * y / (1.0 + k2 * y * y)
        s = np.sqrt(np.maximum(1.0 - k2 * r * r, 0.0))
        ratio = (2.0 / C) / (1.0 + k2 * y * y)  # = r/r̄ = ψ²
        psi_i = np.sqrt(ratio)
        alpha_i = 0.5 * (3.0 * s_R - s)
        p_i = rho_E * (s - s_R) / (3.0 * s_R - s)
        dalpha_i = 0.5 * k2 * r * ratio
        # dψ/dr̄ = ψ(s−1)/(2r̄) = −ψ k² r (r/r̄) / (2(s+1))  (no 1/r̄)
        dpsi_i = -psi_i * k2 * r * ratio / (2.0 * (s + 1.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_e, psi_e, dalpha_e, dpsi_e = _exterior(
                np.where(inside, riso_R, ri), M
            )
        alpha = np.where(inside, alpha_i, alpha_e)
        psi = np.where(inside, psi_i, psi_e)
        dalpha = np.where(inside, dalpha_i, dalpha_e)
        dpsi = np.where(inside, dpsi_i, dpsi_e)
        rhoE = np.where(inside, rho_E, 0.0)
        p = np.where(inside, np.maximum(p_i, 0.0), 0.0)
        return rhoE, p, alpha, psi, dalpha, dpsi

    return TOVStar(M, R, profile)


def polytrope_star(rho_c: float = 1.28e-3, K: float = 100.0,
                   Gamma: float = 2.0, n_steps: int = 40_000) -> TOVStar:
    """RK4-integrated TOV polytrope ``p = KρΓ`` (ρ = rest-mass density,
    ρ_E = ρ + p/(Γ−1)).  Defaults are the classic Γ=2 neutron-star model
    (M ≈ 1.4 in G = c = M☉ = 1 units).

    Profiles are tabulated on the integration grid and evaluated by
    linear interpolation in the isotropic radius (dense grid: the
    interpolation error sits far below scheme errors at test
    resolutions); the exterior is closed-form Schwarzschild.
    """
    p_c = K * rho_c**Gamma

    def rho_of_p(p):
        return (np.maximum(p, 0.0) / K) ** (1.0 / Gamma)

    def rhoE_of_p(p):
        return rho_of_p(p) + np.maximum(p, 0.0) / (Gamma - 1.0)

    # State y = [m, p, φ=ln α (unnormalized), u=ln(r̄/r) (unnormalized)]
    def deriv(r, y):
        m, p, _, _ = y
        rhoE = rhoE_of_p(p)
        denom = r * (r - 2.0 * m)
        common = (m + FOUR_PI * r**3 * p) / denom
        root = np.sqrt(max(1.0 - 2.0 * m / r, 1e-300))
        return np.array([
            FOUR_PI * r * r * rhoE,
            -(rhoE + p) * common,
            common,
            (1.0 - root) / (r * root),
        ])

    # Series start at r0 (regular centre).
    rhoE_c = rhoE_of_p(p_c)
    # Crude surface-radius scale to size the grid; extend if needed.
    r_guess = np.sqrt(p_c / (2.0 * np.pi * (rhoE_c + p_c)
                             * (rhoE_c + 3.0 * p_c) / 3.0))
    r0 = r_guess * 1e-6
    y = np.array([
        FOUR_PI / 3.0 * rhoE_c * r0**3,
        p_c - (2.0 * np.pi / 3.0) * (rhoE_c + p_c)
        * (rhoE_c + 3.0 * p_c) * r0**2,
        0.0,
        0.0,
    ])
    r = r0
    rs, ms, ps, phis, us = [r], [y[0]], [y[1]], [y[2]], [y[3]]
    h = 4.0 * r_guess / n_steps
    p_stop = p_c * 1e-10
    for _ in range(4 * n_steps):
        k1 = deriv(r, y)
        k2 = deriv(r + 0.5 * h, y + 0.5 * h * k1)
        k3 = deriv(r + 0.5 * h, y + 0.5 * h * k2)
        k4 = deriv(r + h, y + h * k3)
        y_new = y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if not np.isfinite(y_new[1]) or y_new[1] <= p_stop:
            # Bisect the last step onto the surface.
            lo, hi = 0.0, h
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                k1 = deriv(r, y)
                k2 = deriv(r + 0.5 * mid, y + 0.5 * mid * k1)
                k3 = deriv(r + 0.5 * mid, y + 0.5 * mid * k2)
                k4 = deriv(r + mid, y + mid * k3)
                y_mid = y + mid / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
                if np.isfinite(y_mid[1]) and y_mid[1] > p_stop:
                    lo = mid
                else:
                    hi = mid
            k1 = deriv(r, y)
            k2 = deriv(r + 0.5 * lo, y + 0.5 * lo * k1)
            k3 = deriv(r + 0.5 * lo, y + 0.5 * lo * k2)
            k4 = deriv(r + lo, y + lo * k3)
            y = y + lo / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            r = r + lo
            rs.append(r); ms.append(y[0]); ps.append(max(y[1], 0.0))
            phis.append(y[2]); us.append(y[3])
            break
        y, r = y_new, r + h
        rs.append(r); ms.append(y[0]); ps.append(y[1])
        phis.append(y[2]); us.append(y[3])
    else:
        raise RuntimeError("TOV integration did not reach the surface")

    rs = np.asarray(rs); ms = np.asarray(ms); ps = np.asarray(ps)
    phis = np.asarray(phis); us = np.asarray(us)
    R, M = rs[-1], ms[-1]
    s_R = np.sqrt(1.0 - 2.0 * M / R)
    riso_R = R * (1.0 + s_R) ** 2 / 4.0
    # Normalizations: α(R) = s_R, r̄(R) = riso_R.
    alphas = np.exp(phis) * (s_R / np.exp(phis[-1]))
    riso = rs * np.exp(us) * (riso_R / (R * np.exp(us[-1])))
    psis = np.sqrt(rs / riso)
    roots = np.sqrt(np.maximum(1.0 - 2.0 * ms / rs, 0.0))
    # dα/dr̄ = α φ'(r) dr/dr̄,  dr/dr̄ = ψ²√(1−2m/r)
    dphi = np.array([deriv(rr, np.array([mm, pp, 0.0, 0.0]))[2]
                     for rr, mm, pp in zip(rs, ms, ps)])
    dalphas = alphas * dphi * psis**2 * roots
    dpsis = psis * (roots - 1.0) / (2.0 * riso)
    rhoEs = rhoE_of_p(ps)

    def profile(ri):
        ri = np.asarray(ri, float)
        inside = ri <= riso_R
        ri_in = np.where(inside, ri, riso_R)
        rhoE = np.where(inside, np.interp(ri_in, riso, rhoEs), 0.0)
        p = np.where(inside, np.maximum(np.interp(ri_in, riso, ps), 0.0),
                     0.0)
        alpha_i = np.interp(ri_in, riso, alphas)
        psi_i = np.interp(ri_in, riso, psis)
        dalpha_i = np.interp(ri_in, riso, dalphas)
        dpsi_i = np.interp(ri_in, riso, dpsis)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_e, psi_e, dalpha_e, dpsi_e = _exterior(
                np.where(inside, riso_R, ri), M
            )
        return (rhoE,
                p,
                np.where(inside, alpha_i, alpha_e),
                np.where(inside, psi_i, psi_e),
                np.where(inside, dalpha_i, dalpha_e),
                np.where(inside, dpsi_i, dpsi_e))

    star = TOVStar(M, R, profile)
    star.rho_c = float(rho_c)
    star.K = float(K)
    star.Gamma = float(Gamma)
    return star


# ----------------------------------------------------------- state builders


def _radial(coords, center):
    rel = [np.asarray(c, float) - center[e] for e, c in enumerate(coords)]
    r = np.sqrt(sum(x * x for x in rel))
    safe = np.where(r > 0.0, r, 1.0)
    n = [np.where(r > 0.0, x / safe, 0.0) for x in rel]
    return r, n


def tov_state(*coords, center, star: TOVStar, gamma: float = 5.0 / 3.0,
              rho_atm: float = 0.0, p_atm: float = 0.0):
    """Var-last :mod:`grhd_cfc` (Cowling) state of the star on a
    Cartesian window (any dim; ``gamma`` is the EVOLUTION Γ-law — the
    rest-mass density ρ = ρ_E − p/(Γ−1) makes the star exactly
    stationary under it).  ``rho_atm``/``p_atm`` floor the exterior for
    windows that cross the surface (0 = interior-window use only)."""
    from exahype_jax.models import grhd_cfc

    r, n = _radial(coords, center)
    rhoE, p, alpha, psi, dalpha_dr, dpsi_dr = star.profile(r)
    rho = rhoE - p / (gamma - 1.0)
    if not (rho_atm > 0.0) and not np.all(r <= star.r_iso_surface):
        raise ValueError(
            "window crosses the stellar surface; pass rho_atm/p_atm floors"
        )
    rho = np.maximum(rho, rho_atm)
    p = np.maximum(p, p_atm)
    v = np.zeros(r.shape + (len(coords),))
    dalpha = np.stack([dalpha_dr * ni for ni in n], -1)
    dpsi = np.stack([dpsi_dr * ni for ni in n], -1)
    return np.asarray(grhd_cfc.pack_state(
        rho, v, p, alpha, psi, dalpha, dpsi, gamma=gamma
    ))


def tov_z4_matter_state(x, y, z, *, center, star: TOVStar,
                        gamma: float = 5.0 / 3.0,
                        rho_atm: float = 0.0, p_atm: float = 0.0):
    """Var-last 43-component COUPLED state
    (:mod:`~exahype_jax.models.z4_matter`) of the star: γ_ij = ψ⁴δ_ij,
    K_ij = 0 (static maximal slice), Θ = Z_i = 0 (constraints satisfied),
    A_k = ∂_k ln α, D_kij = 2ψ³∂_kψ n_k δ_ij, fluid at rest."""
    from exahype_jax.models.z4 import N_VARS as N_Z4
    from exahype_jax.models.z4_matter import pack_matter

    r, n = _radial((x, y, z), center)
    rhoE, p, alpha, psi, dalpha_dr, dpsi_dr = star.profile(r)
    rho = rhoE - p / (gamma - 1.0)
    if not (rho_atm > 0.0) and not np.all(r <= star.r_iso_surface):
        raise ValueError(
            "window crosses the stellar surface; pass rho_atm/p_atm floors"
        )
    rho = np.maximum(rho, rho_atm)
    p = np.maximum(p, p_atm)
    z4 = np.zeros(r.shape + (N_Z4,))
    z4[..., 0] = alpha
    psi4 = psi**4
    z4[..., 1] = z4[..., 4] = z4[..., 6] = psi4           # γ diag (sym6)
    dlnal = dalpha_dr / alpha
    ddiag = 2.0 * psi**3 * dpsi_dr                        # ½∂γ_diag radial
    for k in range(3):
        z4[..., 17 + k] = dlnal * n[k]                    # A_k
        base = 20 + 6 * k                                 # D_k·· sym6 block
        z4[..., base + 0] = ddiag * n[k]                  # D_kxx
        z4[..., base + 3] = ddiag * n[k]                  # D_kyy
        z4[..., base + 5] = ddiag * n[k]                  # D_kzz
    v_low = np.zeros(r.shape + (3,))
    return np.asarray(pack_matter(z4, rho, v_low, p, gamma=gamma))
