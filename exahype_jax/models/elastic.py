"""Linear elasticity (velocity–stress form) — the seismic-wave model family.

Seismic wave propagation is one of the flagship ExaHyPE applications; the
2-D isotropic velocity–stress system is

    state Q = [v_x, v_y, σ_xx, σ_yy, σ_xy]           (5 variables)

    ρ ∂t v_x = ∂x σ_xx + ∂y σ_xy
    ρ ∂t v_y = ∂x σ_xy + ∂y σ_yy
    ∂t σ_xx = (λ+2μ) ∂x v_x + λ ∂y v_y
    ∂t σ_yy = λ ∂x v_x + (λ+2μ) ∂y v_y
    ∂t σ_xy = μ (∂y v_x + ∂x v_y)

written in conservation form ∂t Q + ∂x F_x + ∂y F_y = 0 with linear fluxes.
Wave speeds: c_p = sqrt((λ+2μ)/ρ), c_s = sqrt(μ/ρ).

Batch-native callbacks (variable axis last), usable with the FV spec
builder, the ADER-DG solver (via ``wrap_var_last``), and exact plane-wave
solutions for validation.
"""

from __future__ import annotations

from functools import partial
import math

import jax.numpy as jnp
import numpy as np


def _speeds(rho: float, lam: float, mu: float) -> tuple[float, float]:
    return math.sqrt((lam + 2 * mu) / rho), math.sqrt(mu / rho)


def elastic_flux(Q, normal, *, rho: float = 1.0, lam: float = 2.0, mu: float = 1.0):
    vx, vy = Q[..., 0], Q[..., 1]
    sxx, syy, sxy = Q[..., 2], Q[..., 3], Q[..., 4]
    n = int(normal)
    if n == 0:
        comps = [
            -sxx / rho,
            -sxy / rho,
            -(lam + 2 * mu) * vx,
            -lam * vx,
            -mu * vy,
        ]
    else:
        comps = [
            -sxy / rho,
            -syy / rho,
            -lam * vy,
            -(lam + 2 * mu) * vy,
            -mu * vx,
        ]
    return jnp.stack(comps, axis=-1)


def elastic_eigenvalue(Q, normal, *, rho: float = 1.0, lam: float = 2.0, mu: float = 1.0):
    cp, _ = _speeds(rho, lam, mu)
    return jnp.full(Q.shape[:-1], cp, Q.dtype)


def elastic(rho: float = 1.0, lam: float = 2.0, mu: float = 1.0):
    """(flux, max_eigenvalue) batch-native pair for 2-D elasticity."""
    return (
        partial(elastic_flux, rho=rho, lam=lam, mu=mu),
        partial(elastic_eigenvalue, rho=rho, lam=lam, mu=mu),
    )


def plane_p_wave(x, y, t, *, rho: float = 1.0, lam: float = 2.0, mu: float = 1.0,
                 k: float = 2 * np.pi, amplitude: float = 1e-3):
    """Exact P-wave travelling in +x: v_x = A sin(k(x - c_p t)).

    Returns the 5-variable state on the given coordinate arrays.
    """
    cp, _ = _speeds(rho, lam, mu)
    phase = k * (x - cp * t)
    vx = amplitude * np.sin(phase)
    vy = np.zeros_like(vx)
    # From the PDE: σ_xx = -ρ c_p v_x, σ_yy = -(λ/(λ+2μ)) ρ c_p v_x… derive:
    # travelling-wave ansatz gives σ_xx = -(λ+2μ)/c_p · v_x, σ_yy = -λ/c_p · v_x.
    sxx = -(lam + 2 * mu) / cp * vx
    syy = -lam / cp * vx
    sxy = np.zeros_like(vx)
    return np.stack([vx, vy, sxx, syy, sxy], axis=-1)


# ------------------------------------------------- heterogeneous materials
# State extended with per-cell material parameters carried as non-evolved
# variables: Q = [v_x, v_y, σ_xx, σ_yy, σ_xy, ρ, λ, μ]  (8 variables).
# The fluxes read the material locally and return zeros for the material
# slots, so any solver treats them as frozen fields — the real seismic
# use case (layered media, material interfaces).

N_VARS_HET = 8


def elastic_het_flux(Q, normal):
    vx, vy = Q[..., 0], Q[..., 1]
    sxx, syy, sxy = Q[..., 2], Q[..., 3], Q[..., 4]
    rho, lam, mu = Q[..., 5], Q[..., 6], Q[..., 7]
    inv_rho = 1.0 / rho
    n = int(normal)
    z = jnp.zeros_like(vx)
    if n == 0:
        comps = [
            -sxx * inv_rho,
            -sxy * inv_rho,
            -(lam + 2 * mu) * vx,
            -lam * vx,
            -mu * vy,
        ]
    else:
        comps = [
            -sxy * inv_rho,
            -syy * inv_rho,
            -lam * vy,
            -(lam + 2 * mu) * vy,
            -mu * vx,
        ]
    return jnp.stack(comps + [z, z, z], axis=-1)


def elastic_het_eigenvalue(Q, normal):
    rho, lam, mu = Q[..., 5], Q[..., 6], Q[..., 7]
    return jnp.sqrt((lam + 2 * mu) / rho)


def elastic_heterogeneous():
    """(flux, max_eigenvalue) for 2-D elasticity with per-cell materials."""
    return elastic_het_flux, elastic_het_eigenvalue


# --------------------------------------------------- free-surface boundary
# The ExaSeis boundary condition: a traction-free surface (σ·n = 0) — the
# Earth's surface in seismic runs.  Imposed through the ADER-DG solver's
# reflective-wall hooks as a ghost image whose TRACTION components are
# negated:
#
#   ghost state  = interior with σ·n rows negated
#                  (axis 0: σ_xx, σ_xy;  axis 1: σ_yy, σ_xy),
#   ghost flux   = F(ghost) = interior flux with the VELOCITY rows negated
#                  (F's first two rows are the traction −σ·n/ρ, odd under
#                  the image; the stress rows carry velocities, even).
#
# The Rusanov face flux between interior and image then has exactly ZERO
# momentum flux through the wall (the velocity jump vanishes, the traction
# averages cancel) and a dissipative stress-row term that weakly drives
# σ·n → 0 — the standard ghost formulation.  Unlike the rigid/symmetry
# wall (v·n = 0, which IS an exact mirror image of the continuous system),
# the free-surface ghost is exact only for the y-invariant P subsystem
# (σ_xy ≡ 0); the differential test in tests/test_models.py exploits that.


def _sign_reflect(signs):
    table = np.asarray(signs, np.float64)

    def reflect(Q, axis, var_axis):
        shape = [1] * Q.ndim
        shape[var_axis] = table.shape[-1]
        s = jnp.asarray(table[int(axis)], Q.dtype).reshape(shape)
        return Q * s

    return reflect


def elastic_free_surface():
    """(reflect_fn, reflect_flux_fn) imposing traction-free walls on the
    2-D velocity–stress system via ``ADERDGSolver(boundary="reflective",
    ...)``."""
    state_signs = [
        [1.0, 1.0, -1.0, 1.0, -1.0],   # axis 0: negate σ_xx, σ_xy
        [1.0, 1.0, 1.0, -1.0, -1.0],   # axis 1: negate σ_yy, σ_xy
    ]
    flux_signs = [
        [-1.0, -1.0, 1.0, 1.0, 1.0],   # traction rows odd, both axes
        [-1.0, -1.0, 1.0, 1.0, 1.0],
    ]
    return _sign_reflect(state_signs), _sign_reflect(flux_signs)


def elastic_free_surface_het():
    """Free-surface hooks for the 8-variable heterogeneous system: traction
    rows as in :func:`elastic_free_surface`; the frozen material slots
    (ρ, λ, μ) mirror EVENLY in both state and flux (their flux rows are
    identically zero, so the flux sign is immaterial — kept +1)."""
    even3 = [1.0, 1.0, 1.0]
    state_signs = [
        [1.0, 1.0, -1.0, 1.0, -1.0] + even3,
        [1.0, 1.0, 1.0, -1.0, -1.0] + even3,
    ]
    flux_signs = [
        [-1.0, -1.0, 1.0, 1.0, 1.0] + even3,
        [-1.0, -1.0, 1.0, 1.0, 1.0] + even3,
    ]
    return _sign_reflect(state_signs), _sign_reflect(flux_signs)


# ---------------------------------------------------------- absorbing edges
# Seismic domains are half-spaces: the free surface sits on top and the
# other edges must ABSORB outgoing waves.  The static-shape version of the
# classic sponge layer: a smooth per-cell damping mask folded into the
# solver's algebraic ``source_fn`` (S = −σ(x)·Q_wave), so it rides the
# space-time predictor like any other source — no extra passes, composes
# with walls/sharding/the fused kernel's source path unchanged.


def sponge_source(solver, width: float, rate: float, axes=None,
                  n_wave: int | None = None):
    """``source_fn`` damping the wave variables within ``width`` of the
    domain edges along ``axes`` (default: all), with a squared-cosine
    profile peaking at ``rate`` on the boundary.

    ``n_wave`` limits damping to the first ``n_wave`` variables (default
    all) — use 5 for the heterogeneous system so the material slots stay
    frozen.  Returns a closure matching ``ADERDGSolver.source_fn``.
    """
    import numpy as _np

    dim = solver.dim
    if axes is None:
        axes = tuple(range(dim))
    sigma = _np.zeros(solver.grid_shape)
    for d in axes:
        centers = (_np.arange(solver.grid_shape[d]) + 0.5) * solver._dxs[d]
        extent = solver.grid_shape[d] * solver._dxs[d]
        edge = _np.minimum(centers, extent - centers)
        prof = _np.where(
            edge < width, _np.cos(0.5 * _np.pi * edge / width) ** 2, 0.0
        )
        shape = [1] * dim
        shape[d] = solver.grid_shape[d]
        sigma = _np.maximum(sigma, prof.reshape(shape))
    sigma = rate * sigma
    nv = solver.n_vars if n_wave is None else int(n_wave)
    mask = _np.asarray([1.0] * nv + [0.0] * (solver.n_vars - nv))

    def source(q, var_axis):
        # q may carry a leading time-node axis inside the predictor; the
        # trailing grid axes always line up.
        grid_shape = (1,) * (q.ndim - dim) + tuple(solver.grid_shape)
        s = jnp.asarray(sigma, q.dtype).reshape(grid_shape)
        mshape = [1] * q.ndim
        mshape[var_axis] = solver.n_vars
        m = jnp.asarray(mask, q.dtype).reshape(mshape)
        return -(s * m) * q

    return source


# --------------------------------------------------------- 3-D elasticity
# The production ExaSeis configuration is 3-D: 9 variables
#   Q = [v_x, v_y, v_z, σ_xx, σ_yy, σ_zz, σ_yz, σ_xz, σ_xy]
# (Voigt stress ordering), with
#   ρ ∂t v_i = ∂_j σ_ij,    ∂t σ_ij = λ δ_ij ∂_k v_k + μ(∂_i v_j + ∂_j v_i).

N_VARS_3D = 9

# σ_in component index for (axis n, velocity i): rows of the Voigt vector.
_SIG = {  # (i, j) -> Voigt index (i<=j)
    (0, 0): 3, (1, 1): 4, (2, 2): 5, (1, 2): 6, (0, 2): 7, (0, 1): 8,
}


def _sig_idx(i, j):
    return _SIG[(min(i, j), max(i, j))]


def elastic3d_flux(Q, normal, *, rho: float = 1.0, lam: float = 2.0,
                   mu: float = 1.0):
    n = int(normal)
    v = [Q[..., i] for i in range(3)]
    comps = [None] * N_VARS_3D
    for i in range(3):
        comps[i] = -Q[..., _sig_idx(i, n)] / rho
    for i in range(3):
        for j in range(i, 3):
            val = lam * v[n] if i == j else 0.0 * v[0]
            if i == n:
                val = val + mu * v[j] + (mu * v[j] if j == n else 0.0)
            elif j == n:
                val = val + mu * v[i]
            comps[_sig_idx(i, j)] = -val
    return jnp.stack(comps, axis=-1)


def elastic3d_eigenvalue(Q, normal, *, rho: float = 1.0, lam: float = 2.0,
                         mu: float = 1.0):
    cp, _ = _speeds(rho, lam, mu)
    return jnp.full(Q.shape[:-1], cp, Q.dtype)


def elastic3d(rho: float = 1.0, lam: float = 2.0, mu: float = 1.0):
    """(flux, max_eigenvalue) batch-native pair for 3-D elasticity."""
    return (
        partial(elastic3d_flux, rho=rho, lam=lam, mu=mu),
        partial(elastic3d_eigenvalue, rho=rho, lam=lam, mu=mu),
    )


def elastic3d_free_surface():
    """Traction-free hooks for the 3-D system: per wall axis n, the state
    ghost negates the three σ_in rows; the flux ghost negates the three
    velocity (traction) rows."""
    state_signs = []
    for n in range(3):
        s = [1.0] * N_VARS_3D
        for i in range(3):
            s[_sig_idx(i, n)] = -1.0
        state_signs.append(s)
    flux_signs = [[-1.0] * 3 + [1.0] * 6] * 3
    return _sign_reflect(state_signs), _sign_reflect(flux_signs)


def plane_p_wave_3d(x, t, *, rho: float = 1.0, lam: float = 2.0,
                    mu: float = 1.0, k: float = 2 * np.pi,
                    amplitude: float = 1e-3):
    """Exact P wave travelling in +x; returns the 9-variable state on the
    coordinate array ``x`` (variable axis last)."""
    cp, _ = _speeds(rho, lam, mu)
    vx = amplitude * np.sin(k * (x - cp * t))
    z = np.zeros_like(vx)
    return np.stack(
        [vx, z, z,
         -(lam + 2 * mu) / cp * vx, -lam / cp * vx, -lam / cp * vx,
         z, z, z],
        axis=-1,
    )


def plane_s_wave_3d(x, t, *, rho: float = 1.0, lam: float = 2.0,
                    mu: float = 1.0, k: float = 2 * np.pi,
                    amplitude: float = 1e-3):
    """Exact S wave travelling in +x, polarized in y (v_y, σ_xy only)."""
    _, cs = _speeds(rho, lam, mu)
    vy = amplitude * np.sin(k * (x - cs * t))
    z = np.zeros_like(vy)
    return np.stack(
        [z, vy, z, z, z, z, z, z, -mu / cs * vy], axis=-1
    )


# ------------------------------------- heterogeneous materials in 3-D
# The production ExaSeis configuration: the 9-variable velocity–stress
# system extended with per-cell (ρ, λ, μ) as frozen variables —
# Q = [v_x, v_y, v_z, σ_xx, σ_yy, σ_zz, σ_yz, σ_xz, σ_xy, ρ, λ, μ]
# (12 variables).  Fluxes are linear HOMOGENEOUS in the evolved slots
# given the materials with zero material flux rows, so the system
# composes with the CK linear predictor via
# ``ck_material_slots=(9, 10, 11)`` exactly.

N_VARS_3D_HET = 12


def elastic3d_het_flux(Q, normal):
    n = int(normal)
    v = [Q[..., i] for i in range(3)]
    rho, lam, mu = Q[..., 9], Q[..., 10], Q[..., 11]
    inv_rho = 1.0 / rho
    z = jnp.zeros_like(v[0])
    comps = [None] * N_VARS_3D_HET
    for i in range(3):
        comps[i] = -Q[..., _sig_idx(i, n)] * inv_rho
    for i in range(3):
        for j in range(i, 3):
            val = lam * v[n] if i == j else z
            if i == n:
                val = val + mu * v[j] + (mu * v[j] if j == n else 0.0)
            elif j == n:
                val = val + mu * v[i]
            comps[_sig_idx(i, j)] = -val
    comps[9] = comps[10] = comps[11] = z
    return jnp.stack(comps, axis=-1)


def elastic3d_het_eigenvalue(Q, normal):
    rho, lam, mu = Q[..., 9], Q[..., 10], Q[..., 11]
    return jnp.sqrt((lam + 2 * mu) / rho)


def elastic3d_heterogeneous():
    """(flux, max_eigenvalue) for 3-D elasticity with per-cell materials."""
    return elastic3d_het_flux, elastic3d_het_eigenvalue


def elastic3d_free_surface_het():
    """Traction-free hooks for the 12-variable heterogeneous 3-D system:
    per wall axis n the state ghost negates the three σ_in rows, the flux
    ghost negates the velocity (traction) rows; the frozen material slots
    mirror evenly (their flux rows are identically zero)."""
    state_signs = []
    for n in range(3):
        s = [1.0] * N_VARS_3D_HET
        for i in range(3):
            s[_sig_idx(i, n)] = -1.0
        state_signs.append(s)
    flux_signs = [
        [-1.0] * 3 + [1.0] * 6 + [1.0] * 3 for _ in range(3)
    ]
    return _sign_reflect(state_signs), _sign_reflect(flux_signs)
