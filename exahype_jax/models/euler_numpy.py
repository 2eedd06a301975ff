"""NumPy compressible-Euler physics with C-like pointer semantics.

Independent oracle-side counterpart of :mod:`exahype_jax.models.euler`,
structured like the reference's native physics (``Unit test/Functions.cpp``):
``flux`` writes its result through the out-parameter view, exactly as the
C ABI version does, so the NumPy oracle exercises the same calling
convention the generated C++ uses.
"""

from __future__ import annotations

import math

GAMMA = 1.4


def _pressure(Q, dim: int, gamma: float) -> float:
    kinetic = Q[1] * Q[1] + Q[2] * Q[2]
    if dim == 3:
        kinetic += Q[3] * Q[3]
    return (gamma - 1.0) * (Q[dim + 1] - 0.5 * (1.0 / Q[0]) * kinetic)


def make_flux(dim: int = 2, n_real: int = 5, gamma: float = GAMMA):
    def flux(Q, normal, F):
        n = int(normal)
        inv_rho = 1.0 / Q[0]
        p = _pressure(Q, dim, gamma)
        coeff = inv_rho * Q[n + 1]
        for k in range(dim + 1):
            F[k] = coeff * Q[k]
        F[n + 1] = F[n + 1] + p
        F[dim + 1] = coeff * Q[dim + 1] + coeff * p
        for k in range(dim + 2, n_real):
            F[k] = 0.0
        return 0

    return flux


def make_max_eigenvalue(dim: int = 2, gamma: float = GAMMA):
    def max_eigenvalue(Q, normal):
        n = int(normal)
        inv_rho = 1.0 / abs(Q[0])
        p = _pressure(Q, dim, gamma)
        c = math.sqrt(gamma * abs(p) * inv_rho)
        u_n = Q[n + 1] * inv_rho
        return max(abs(u_n - c), abs(u_n + c))

    return max_eigenvalue


def scalar_max(a, b):
    return max(a, b)


def impls(dim: int = 2, n_real: int = 5, gamma: float = GAMMA):
    """Impl map for :func:`exahype_jax.backends.numpy_oracle.run_oracle`."""
    return {
        "Flux": make_flux(dim=dim, n_real=n_real, gamma=gamma),
        "maxEigenvalue": make_max_eigenvalue(dim=dim, gamma=gamma),
        "max": scalar_max,
    }
