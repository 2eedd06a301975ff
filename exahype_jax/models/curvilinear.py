"""Curvilinear (mapped) meshes: ADER-DG on smoothly deformed grids.

The reference family's seismic application runs on curvilinear meshes to
fit surface topography (curvilinear ExaSeis).  This version
keeps the solver Cartesian in REFERENCE coordinates ξ ∈ [0,L]^dim and
moves the geometry into the PHYSICS through the strong-conservation
curvilinear form

    ∂t (J q) + ∂_ξk ( J a^k_i F_i(q) ) = 0,      a^k_i = ∂ξ^k/∂x_i,

so the evolved state is the DENSITIZED field Q̃ = J·q and the flux along
reference axis k is the metric-weighted combination of the physical
fluxes.  The metric terms (J and the dim² contravariant entries J·a^k_i)
ride as FROZEN per-node variable slots — exactly the heterogeneous-
material mechanism the solver stack already supports everywhere
(predictor, corrector, limiter, pools, sharding), and for linear physics
the transformed flux stays linear HOMOGENEOUS in Q̃ given the metric
slots, so the Cauchy–Kovalewski linear kernels compose through
``ck_material_slots`` unchanged.

Discrete geometry — two constructions:

- :func:`metric_fields` (analytic): metrics EXACTLY from the user's
  mapping x(ξ) by forward-mode autodiff at every node.  The discrete
  metric identities ∂_ξk(J a^k_i) = 0 then hold only to truncation
  order — free-stream is preserved to scheme order, not rounding.  The
  identity defect is O(h^N): in 2-D it sits below the scheme error
  (advection measured at N+1), in 3-D it is the visible floor.
- :func:`metric_fields_curl` (round 5): Kopriva's conservative
  CURL-FORM discrete metrics, evaluated with the solver's own
  collocation D — the in-cell identity holds to ROUNDING (commuting
  tensor-product derivatives), lifting the 3-D floor; with
  ``basis="lobatto"`` the face normal metric is single-valued and
  free-stream holds to machine precision (tested).

Conservation is exact in the densitized field either way:
Σ w·Q̃ = ∫ q J dξ = ∫ q dx telescopes to rounding on periodic domains.

Slot layout: ``[wave (n_wave), J, J·a^0_0 … J·a^0_{dim-1}, J·a^1_0, …]``
(k-major), total ``n_wave + 1 + dim²`` variables.

Reference: the curvilinear treatment mirrors what ExaHyPE's seismic
applications do on top of `/root/reference/exahype/KernelBuilder.py`-built
kernels; the reference repo itself bundles only Cartesian Euler
(`Unit test/Functions.cpp`), so this is a family capability.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def n_vars_curvilinear(n_wave: int, dim: int) -> int:
    return n_wave + 1 + dim * dim


def curvilinear_physics(flux: Callable, eig: Callable, dim: int,
                        n_wave: int):
    """Lift batch-native var-last ``(flux(q, normal), eig(q, normal))``
    physical callbacks onto the densitized curvilinear state.

    The returned eigenvalue is the Rusanov-safe bound
    ‖a^k‖₂ · max_i λ_i(q): exact for isotropic wave speeds (elastic,
    acoustics), an upper bound otherwise (more face dissipation, never
    instability).
    """

    def cflux(Q, normal):
        k = int(normal)
        J = Q[..., n_wave]
        q = Q[..., :n_wave] / J[..., None]
        rows = None
        for i in range(dim):
            Jak_i = Q[..., n_wave + 1 + k * dim + i]
            term = Jak_i[..., None] * flux(q, i)
            rows = term if rows is None else rows + term
        return jnp.concatenate(
            [rows, jnp.zeros_like(Q[..., n_wave:])], axis=-1
        )

    def ceig(Q, normal):
        k = int(normal)
        J = Q[..., n_wave]
        q = Q[..., :n_wave] / J[..., None]
        norm2 = None
        for i in range(dim):
            a = Q[..., n_wave + 1 + k * dim + i] / J
            norm2 = a * a if norm2 is None else norm2 + a * a
        lam = eig(q, 0)
        for i in range(1, dim):
            lam = jnp.maximum(lam, eig(q, i))
        return jnp.sqrt(norm2) * lam

    return cflux, ceig


def curvilinear_dissipation_mask(n_wave: int, dim: int) -> tuple:
    """Freeze the metric slots against Rusanov jump dissipation."""
    return (1,) * n_wave + (0,) * (1 + dim * dim)


def curvilinear_material_slots(n_wave: int, dim: int) -> tuple:
    """The frozen metric slots — pass as ``ck_material_slots`` for the CK
    linear kernels on curvilinear linear systems."""
    return tuple(range(n_wave, n_wave + 1 + dim * dim))


def metric_fields(solver, mapping: Callable):
    """Exact nodal metric slots and physical node coordinates for a
    smooth mapping ``x = mapping(ξ)`` (dim-vector → dim-vector).

    Returns ``(metric, xphys)``:

    - ``metric``: ndarray shaped like the solver state with the var axis
      of length ``1 + dim²`` — ``[J, J·a^k_i (k-major)]`` at every node,
      from forward-mode autodiff of the mapping (no finite differences).
    - ``xphys``: list of dim arrays (var axis squeezed) of physical node
      coordinates, for sampling initial data given in physical space.
    """
    dim = solver.dim
    coords = solver.nodes_meshgrid()
    no_var = tuple(
        s for e, s in enumerate(solver.state_shape)
        if e != solver.var_axis
    )
    xi = np.stack(
        [
            np.broadcast_to(
                np.squeeze(np.asarray(c), solver.var_axis), no_var
            )
            for c in coords
        ],
        axis=-1,
    ).reshape(-1, dim)

    jac_fn = jax.vmap(jax.jacfwd(lambda p: jnp.asarray(mapping(p))))
    A = np.asarray(jac_fn(jnp.asarray(xi)))          # [N, dim, dim] dx/dξ
    x = np.asarray(jax.vmap(lambda p: jnp.asarray(mapping(p)))(
        jnp.asarray(xi)
    ))
    J = np.linalg.det(A)
    if np.any(J <= 0):
        raise ValueError(
            "mapping must be orientation-preserving (det dx/dξ > 0 at "
            "every node)"
        )
    Ainv = np.linalg.inv(A)                          # [N, k, i] = ∂ξk/∂xi
    slots = [J] + [
        J * Ainv[:, k, i] for k in range(dim) for i in range(dim)
    ]
    metric = np.stack(slots, axis=-1).reshape(no_var + (1 + dim * dim,))
    metric = np.moveaxis(metric, -1, solver.var_axis)
    xphys = [
        x[:, d].reshape(no_var) for d in range(dim)
    ]
    return metric, xphys


def metric_fields_curl(solver, mapping: Callable):
    """Kopriva CURL-FORM discrete metric slots (free-stream-preserving).

    Same return contract as :func:`metric_fields`, but the contravariant
    entries ``J·a^k_i`` come from Kopriva's conservative curl form
    evaluated with the solver's OWN collocation derivative matrix D:

    - 2-D: ``Ja¹ = ( D₂x₂, −D₂x₁)``, ``Ja² = (−D₁x₂,  D₁x₁)``;
    - 3-D (cyclic n,p,q): ``Ja^n_i = ½ ε_ijm [D_p(x_j D_q x_m)
      − D_q(x_j D_p x_m)]``.

    Because tensor-product collocation derivatives along DIFFERENT
    reference axes commute on any nodal data, the discrete metric
    identity ``Σ_k D_k (J a^k_i) = 0`` holds to ROUNDING per cell — the
    in-cell free-stream defect of :func:`metric_fields` (O(h^N), the
    visible 3-D floor) vanishes.  The remaining free-stream error is the
    inter-cell face mismatch of the extrapolated metric, O(h^{N+1}) on
    Legendre nodes; with ``basis="lobatto"`` the curl form's normal
    metric component at a face depends ONLY on tangential derivatives of
    the (shared) face nodes' coordinates, so the face flux is
    single-valued and free-stream holds to rounding (the watertightness
    property the curl form was designed for — Kopriva, J. Sci. Comput.
    26 (2006)).  ``J`` itself stays the exact pointwise Jacobian (it
    never enters the identity: the wave state is divided by the same J
    it was multiplied by).
    """
    dim = solver.dim
    coords = solver.nodes_meshgrid()
    no_var = tuple(
        s for e, s in enumerate(solver.state_shape)
        if e != solver.var_axis
    )
    xi = np.stack(
        [
            np.broadcast_to(
                np.squeeze(np.asarray(c), solver.var_axis), no_var
            )
            for c in coords
        ],
        axis=-1,
    ).reshape(-1, dim)
    x_flat = np.asarray(
        jax.vmap(lambda p: jnp.asarray(mapping(p)))(jnp.asarray(xi))
    )
    A = np.asarray(
        jax.vmap(jax.jacfwd(lambda p: jnp.asarray(mapping(p))))(
            jnp.asarray(xi)
        )
    )
    J = np.linalg.det(A)
    if np.any(J <= 0):
        raise ValueError(
            "mapping must be orientation-preserving (det dx/dξ > 0 at "
            "every node)"
        )
    # Nodal coordinate fields in the solver's [nodes^dim, *grid] layout
    # (node axis of reference direction q is axis q).
    x = [x_flat[:, m].reshape(no_var) for m in range(dim)]
    D = np.asarray(solver.ops.D)
    dxs = solver._dxs

    def dref(f, q):
        """Per-cell collocation derivative along reference axis q."""
        out = np.tensordot(D, np.moveaxis(f, q, 0), axes=([1], [0]))
        return np.moveaxis(out, 0, q) / float(dxs[q])

    if dim == 2:
        Ja = [
            [dref(x[1], 1), -dref(x[0], 1)],     # Ja^0_i
            [-dref(x[1], 0), dref(x[0], 0)],     # Ja^1_i
        ]
    elif dim == 3:
        eps = np.zeros((3, 3, 3))
        for i, j, m in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            eps[i, j, m] = 1.0
            eps[i, m, j] = -1.0
        # Precompute D_q x_m for all q, m.
        dx = [[dref(x[m], q) for m in range(3)] for q in range(3)]
        Ja = []
        for n in range(3):
            p, q = (n + 1) % 3, (n + 2) % 3
            row = []
            for i in range(3):
                acc = 0.0
                for j in range(3):
                    for m in range(3):
                        e = eps[i, j, m]
                        if e == 0.0:
                            continue
                        acc = acc + 0.5 * e * (
                            dref(x[j] * dx[q][m], p)
                            - dref(x[j] * dx[p][m], q)
                        )
                row.append(acc)
            Ja.append(row)
    else:
        raise ValueError("curl-form metrics are defined for dim in (2, 3)")

    slots = [J.reshape(no_var)] + [
        Ja[k][i] for k in range(dim) for i in range(dim)
    ]
    metric = np.stack(slots, axis=-1).reshape(no_var + (1 + dim * dim,))
    metric = np.moveaxis(metric, -1, solver.var_axis)
    xphys = [x_flat[:, d].reshape(no_var) for d in range(dim)]
    return metric, xphys


def densitize(q_wave, metric, var_axis: int):
    """Assemble the solver state from physical wave variables and the
    metric slots: ``Q̃ = [J·q, J, J·a…]`` along ``var_axis``."""
    J = jnp.take(jnp.asarray(metric), jnp.asarray([0]), axis=var_axis)
    return jnp.concatenate(
        [jnp.asarray(q_wave) * J, jnp.asarray(metric)], axis=var_axis
    )


def undensitize(Q, n_wave: int, var_axis: int):
    """Physical wave variables q = Q̃_wave / J from the solver state."""
    Q = jnp.asarray(Q)
    wave = jnp.take(Q, jnp.arange(n_wave), axis=var_axis)
    J = jnp.take(Q, jnp.asarray([n_wave]), axis=var_axis)
    return wave / J
