"""Compressible-Euler physics callbacks (JAX).

The reference supplies these as opaque C++ functions linked into the
generated kernel (``Unit test/Functions.cpp:9-62``: ``Flux``,
``maxEigenvalue``, pointer ``max``).  Here they are traceable JAX callables
that the JAX backend inlines straight into the compiled kernel — the
equivalent of the reference's ``exahype2::Solver::Offloadable``
GPU-offload convention (``Unit test/correctness_test.cpp:53-99``).

State-vector convention (matching the reference): ``Q = [rho, m_x, m_y,
(m_z,) E, aux...]`` — density, momentum components, total energy.  In 2-D the
reference uses ``n_real=5`` with the fifth conserved slot unused; our flux
writes an explicit zero there (the reference leaves the slot's temp storage
uninitialized, ``Unit test/test.cpp:4-7`` `new` without value-init — one of
the catalogued reference hazards this rebuild fixes by zero-initializing all
temporaries).

All functions follow the per-cell contract of the kernel-spec DSL: struct
pointer parameters arrive as 1-D variable vectors, scalars as 0-d values; the
backend vmaps over patch and spatial axes.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

GAMMA = 1.4


def _pressure(Q, dim: int, gamma: float):
    rho = Q[0]
    inv_rho = 1.0 / rho
    kinetic = Q[1] * Q[1] + Q[2] * Q[2]
    if dim == 3:
        kinetic = kinetic + Q[3] * Q[3]
    e = Q[dim + 1]
    return (gamma - 1.0) * (e - 0.5 * inv_rho * kinetic)


def flux(Q, normal, *, dim: int = 2, n_real: int = 5, gamma: float = GAMMA):
    """Euler flux along axis ``normal`` (0-based), per cell.

    ``Q``: (n_vars,) cell state; ``normal``: static axis index (the backend
    binds directional constants statically at trace time).  Returns an
    ``(n_real,)`` flux vector.
    """
    n = int(normal)
    rho = Q[0]
    inv_rho = 1.0 / rho
    p = _pressure(Q, dim, gamma)
    coeff = inv_rho * Q[n + 1]

    comps = [coeff * Q[k] for k in range(dim + 1)]  # mass + momentum advection
    comps[n + 1] = comps[n + 1] + p  # pressure on the normal momentum
    comps.append(coeff * Q[dim + 1] + coeff * p)  # energy flux
    while len(comps) < n_real:
        comps.append(jnp.zeros_like(rho))
    return jnp.stack(comps[:n_real])


def max_eigenvalue(Q, normal, *, dim: int = 2, gamma: float = GAMMA):
    """Largest characteristic wave speed |u_n| + c along axis ``normal``.

    Matches the reference formulation (``Unit test/Functions.cpp:39-62``):
    absolute values guard against non-physical intermediate states.
    """
    n = int(normal)
    inv_rho = 1.0 / jnp.abs(Q[0])
    p = _pressure(Q, dim, gamma)
    c = jnp.sqrt(gamma * jnp.abs(p) * inv_rho)
    u_n = Q[n + 1] * inv_rho
    return jnp.maximum(jnp.abs(u_n - c), jnp.abs(u_n + c))


def scalar_max(a, b):
    """Pointer-``max`` analogue (``Unit test/Functions.cpp:64-65``)."""
    return jnp.maximum(a, b)


def flux_fn(dim: int = 2, n_real: int = 5, gamma: float = GAMMA):
    return partial(flux, dim=dim, n_real=n_real, gamma=gamma)


def max_eigenvalue_fn(dim: int = 2, gamma: float = GAMMA):
    return partial(max_eigenvalue, dim=dim, gamma=gamma)


# ---------------------------------------------------------------- vectorized
# Batch-native variants (TypedFunction(vectorized=True) contract): the
# variable axis is the LAST axis, any number of leading cell axes.  Same
# arithmetic, same operation order as the per-cell forms — differential
# parity with the NumPy oracle is preserved bit-for-bit on CPU — but they
# trace to one fused elementwise op over the whole region instead of a
# vmap nest — the batched shape of the reference's per-cell C callbacks.


def _pressure_v(Q, dim: int, gamma: float):
    rho = Q[..., 0]
    inv_rho = 1.0 / rho
    kinetic = Q[..., 1] * Q[..., 1] + Q[..., 2] * Q[..., 2]
    if dim == 3:
        kinetic = kinetic + Q[..., 3] * Q[..., 3]
    e = Q[..., dim + 1]
    return (gamma - 1.0) * (e - 0.5 * inv_rho * kinetic)


def flux_v(Q, normal, *, dim: int = 2, n_real: int = 5, gamma: float = GAMMA):
    n = int(normal)
    rho = Q[..., 0]
    inv_rho = 1.0 / rho
    p = _pressure_v(Q, dim, gamma)
    coeff = inv_rho * Q[..., n + 1]
    comps = [coeff * Q[..., k] for k in range(dim + 1)]
    comps[n + 1] = comps[n + 1] + p
    comps.append(coeff * Q[..., dim + 1] + coeff * p)
    while len(comps) < n_real:
        comps.append(jnp.zeros_like(rho))
    return jnp.stack(comps[:n_real], axis=-1)


def max_eigenvalue_v(Q, normal, *, dim: int = 2, gamma: float = GAMMA):
    n = int(normal)
    inv_rho = 1.0 / jnp.abs(Q[..., 0])
    p = _pressure_v(Q, dim, gamma)
    c = jnp.sqrt(gamma * jnp.abs(p) * inv_rho)
    u_n = Q[..., n + 1] * inv_rho
    return jnp.maximum(jnp.abs(u_n - c), jnp.abs(u_n + c))


def flux_v_fn(dim: int = 2, n_real: int = 5, gamma: float = GAMMA):
    return partial(flux_v, dim=dim, n_real=n_real, gamma=gamma)


def max_eigenvalue_v_fn(dim: int = 2, gamma: float = GAMMA):
    return partial(max_eigenvalue_v, dim=dim, gamma=gamma)


# ------------------------------------------------------------------- SoA-P
# The ADER-DG layout: the variable axis sits at position ``var_axis``
# counted from the FRONT (default ``dim``, after the node axes); any number
# of cell-grid axes trail — ``[*nodes, var, *grid]``.  Same arithmetic and
# operation order as the other variants.


def _v(Q, k: int, axis: int):
    """Select variable ``k`` (var axis at front position ``axis``)."""
    return Q[(slice(None),) * axis + (k,)]


def _pressure_soa(Q, dim: int, gamma: float, va: int):
    inv_rho = 1.0 / _v(Q, 0, va)
    kinetic = _v(Q, 1, va) * _v(Q, 1, va) + _v(Q, 2, va) * _v(Q, 2, va)
    if dim == 3:
        kinetic = kinetic + _v(Q, 3, va) * _v(Q, 3, va)
    return (gamma - 1.0) * (_v(Q, dim + 1, va) - 0.5 * inv_rho * kinetic)


def flux_soa(
    Q, normal, *, dim: int = 2, n_real: int = 5, gamma: float = GAMMA,
    var_axis: int | None = None,
):
    n = int(normal)
    va = dim if var_axis is None else var_axis
    inv_rho = 1.0 / _v(Q, 0, va)
    p = _pressure_soa(Q, dim, gamma, va)
    coeff = inv_rho * _v(Q, n + 1, va)
    comps = [coeff * _v(Q, k, va) for k in range(dim + 1)]
    comps[n + 1] = comps[n + 1] + p
    comps.append(coeff * _v(Q, dim + 1, va) + coeff * p)
    while len(comps) < n_real:
        comps.append(jnp.zeros_like(p))
    return jnp.stack(comps[:n_real], axis=va)


def max_eigenvalue_soa(
    Q, normal, *, dim: int = 2, gamma: float = GAMMA, var_axis: int | None = None
):
    n = int(normal)
    va = dim if var_axis is None else var_axis
    inv_rho = 1.0 / jnp.abs(_v(Q, 0, va))
    p = _pressure_soa(Q, dim, gamma, va)
    c = jnp.sqrt(gamma * jnp.abs(p) * inv_rho)
    u_n = _v(Q, n + 1, va) * inv_rho
    return jnp.maximum(jnp.abs(u_n - c), jnp.abs(u_n + c))


def gravity_source(dim: int, g, n_real: int | None = None):
    """Uniform-gravity source for the conserved Euler state
    ``[ρ, m_1..m_dim, E, (aux…)]``: ``∂t m_d = ρ g_d``, ``∂t E = m·g``.

    Matches the ``ADERDGSolver.source_fn(q, var_axis)`` contract (and the
    limiter fallbacks' source path).  ``g`` is a per-axis tuple or a
    scalar applied to the LAST axis (the usual "downward" convention).
    Aux slots beyond ``dim+2`` receive zero.
    """
    if not isinstance(g, (tuple, list)):
        gv = [0.0] * dim
        gv[dim - 1] = float(g)
    else:
        if len(g) != dim:
            from exahype_jax.utils.errors import SemanticError

            raise SemanticError(f"gravity needs {dim} components, got {len(g)}")
        gv = [float(c) for c in g]

    def source(q, var_axis):
        rho = _v(q, 0, var_axis)
        parts = [jnp.zeros_like(rho)]
        for d in range(dim):
            parts.append(gv[d] * rho)
        e = jnp.zeros_like(rho)
        for d in range(dim):
            e = e + gv[d] * _v(q, 1 + d, var_axis)
        parts.append(e)
        nv = q.shape[var_axis] if n_real is None else n_real
        while len(parts) < nv:
            parts.append(jnp.zeros_like(rho))
        return jnp.stack(parts[:nv], axis=var_axis)

    return source
