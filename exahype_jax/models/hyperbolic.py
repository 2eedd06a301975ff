"""Model-family registry: hyperbolic PDE systems beyond Euler.

The reference is physics-agnostic — its only bundled system is compressible
Euler in the native test fixture (``Unit test/Functions.cpp``).  This module
supplies the standard hyperbolic model families users of such a framework
expect, each as batch-native JAX callbacks (variable axis last) usable with
both the FV Rusanov spec builder and the ADER-DG solver:

- linear advection (any n_vars)
- Burgers (scalar, per-axis velocity component form)
- shallow water (d+1 variables: h, hu, hv[, hw])
- linear acoustics (pressure-velocity system)
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax.numpy as jnp


# ------------------------------------------------------------------ advection


def advection_flux(Q, normal, *, velocity):
    return float(velocity[int(normal)]) * Q


def advection_eigenvalue(Q, normal, *, velocity):
    return jnp.full(Q.shape[:-1], abs(float(velocity[int(normal)])), Q.dtype)


def advection(velocity):
    """Linear advection with constant velocity vector."""
    return (
        partial(advection_flux, velocity=velocity),
        partial(advection_eigenvalue, velocity=velocity),
    )


# -------------------------------------------------------------------- burgers


def burgers_flux(Q, normal):
    """Multi-dimensional Burgers: F_d = 0.5 * u_d * Q (velocity = state)."""
    n = int(normal)
    return 0.5 * Q[..., n : n + 1] * Q


def burgers_eigenvalue(Q, normal):
    n = int(normal)
    return jnp.max(jnp.abs(Q), axis=-1)


def burgers():
    return burgers_flux, burgers_eigenvalue


# -------------------------------------------------------------- shallow water


def shallow_water_flux(Q, normal, *, dim: int = 2, g: float = 9.81):
    """F for [h, hu, hv(, hw)]: mass + momentum with hydrostatic pressure."""
    n = int(normal)
    h = Q[..., 0]
    u_n = Q[..., n + 1] / h
    comps = [Q[..., n + 1]]  # mass flux = normal momentum
    for k in range(1, dim + 1):
        comps.append(u_n * Q[..., k])
    comps[n + 1] = comps[n + 1] + 0.5 * g * h * h
    return jnp.stack(comps, axis=-1)


def shallow_water_eigenvalue(Q, normal, *, g: float = 9.81):
    n = int(normal)
    h = Q[..., 0]
    u_n = Q[..., n + 1] / h
    c = jnp.sqrt(g * h)
    return jnp.abs(u_n) + c


def shallow_water(dim: int = 2, g: float = 9.81):
    return (
        partial(shallow_water_flux, dim=dim, g=g),
        partial(shallow_water_eigenvalue, g=g),
    )


# ------------------------------------------------------------------ acoustics


def acoustic_flux(Q, normal, *, dim: int = 2, c: float = 1.0, rho0: float = 1.0):
    """Linear acoustics [p, u, v(, w)]: p_t + ρc²∇·u = 0, u_t + ∇p/ρ = 0."""
    n = int(normal)
    p = Q[..., 0]
    comps = [rho0 * c * c * Q[..., n + 1]]
    for k in range(1, dim + 1):
        comps.append(jnp.where(jnp.full(p.shape, k == n + 1), p / rho0, jnp.zeros_like(p)))
    return jnp.stack(comps, axis=-1)


def acoustic_eigenvalue(Q, normal, *, c: float = 1.0):
    return jnp.full(Q.shape[:-1], c, Q.dtype)


def acoustic(dim: int = 2, c: float = 1.0, rho0: float = 1.0):
    return (
        partial(acoustic_flux, dim=dim, c=c, rho0=rho0),
        partial(acoustic_eigenvalue, c=c),
    )


def _elastic(**kw):
    from exahype_jax.models.elastic import elastic

    return elastic(**kw)


def _mhd(**kw):
    from exahype_jax.models.mhd import mhd

    return mhd(**kw)


def _srhd(**kw):
    from exahype_jax.models.srhd import srhd

    return srhd(**kw)


def _rmhd(**kw):
    from exahype_jax.models.rmhd import rmhd

    return rmhd(**kw)


def _grhd(**kw):
    from exahype_jax.models.grhd import grhd

    return grhd(**kw)


def _elastic3d(**kw):
    from exahype_jax.models.elastic import elastic3d

    return elastic3d(**kw)


#: name -> factory returning (flux, max_eigenvalue) batch-native callbacks.
REGISTRY: dict[str, Callable] = {
    "advection": advection,
    "burgers": burgers,
    "shallow_water": shallow_water,
    "acoustic": acoustic,
    "elastic": _elastic,
    "mhd": _mhd,
    "srhd": _srhd,
    "rmhd": _rmhd,
    "grhd": _grhd,
    "elastic3d": _elastic3d,
}
