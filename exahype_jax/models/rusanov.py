"""The canonical batched-stateless FV Rusanov kernel spec.

Library form of the reference's flagship example
(``examples/Batched_stateless.py:9-38``): a finite-volume patch update for a
hyperbolic system using directional fluxes plus Rusanov (local
Lax-Friedrichs) dissipation.  The statement sequence is preserved exactly:

1. ``Q_copy = Q``                                   (copy patch)
2. per-axis ``Flux(Q_copy, normal, tmp_flux)``       (flux evaluation)
3. per-axis ``tmp_eigen = maxEigenvalue(Q_copy, n)`` (wave speeds)
4. per-axis ``Q_copy += 0.5*(tmp_flux[-1] - tmp_flux[+1])``
5. per-axis Rusanov dissipation with neighbour eigenvalues
6. ``Q = Q_copy`` interior write-back
"""

from __future__ import annotations

from typing import Callable, Optional

from sympy.codegen.ast import integer, none, real

from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.models import euler


def build_rusanov_kernel(
    dim: int = 2,
    patch_size: int = 4,
    halo_size: int = 1,
    n_real: int = 5,
    n_aux: int = 5,
    n_patches: int = 1,
    flux_impl: Optional[Callable] = None,
    eigenvalue_impl: Optional[Callable] = None,
    vectorized: bool = True,
) -> KernelBuilder:
    """Build the canonical Rusanov patch-update kernel spec.

    Defaults reproduce the reference test configuration
    (``Unit test/correctness_test.cpp:177-181``): 2-D, patch 4, halo 1,
    5 real + 5 aux variables, compressible Euler physics.  ``vectorized``
    selects the batch-native physics (fast path); per-cell impls are the
    reference-ABI-shaped alternative.  Custom physics: pass batch-native
    ``flux_impl(Q, normal)`` / ``eigenvalue_impl(Q, normal)``.
    """
    if flux_impl is None:
        flux_impl = (
            euler.flux_v_fn(dim=dim, n_real=n_real)
            if vectorized
            else euler.flux_fn(dim=dim, n_real=n_real)
        )
    if eigenvalue_impl is None:
        eigenvalue_impl = (
            euler.max_eigenvalue_v_fn(dim=dim)
            if vectorized
            else euler.max_eigenvalue_fn(dim=dim)
        )

    kernel = KernelBuilder(
        dim=dim,
        patch_size=patch_size,
        halo_size=halo_size,
        n_real=n_real,
        n_aux=n_aux,
        n_patches=n_patches,
    )

    Q = kernel.item("Q")
    Q_copy = kernel.item("Q_copy")
    tmp_flux = kernel.directional_item("tmp_flux")
    tmp_eig = kernel.directional_item("tmp_eigen", struct=False)

    dt = kernel.const("dt")
    kernel.directional_const("normal", list(range(dim)))
    normal = kernel.all_items["normal"]

    Flux = kernel.function(
        "Flux",
        parameter_types=[Q, real, Q],
        return_type=integer,
        jax_impl=flux_impl,
        out_param=2,
        vectorized=vectorized,
    )
    Eigen = kernel.function(
        "maxEigenvalue",
        parameter_types=[Q, real],
        return_type=real,
        jax_impl=eigenvalue_impl,
        vectorized=vectorized,
    )
    Max = kernel.function(
        "max",
        parameter_types=[Q, Q],
        return_type=none,
        jax_impl=euler.scalar_max,
        vectorized=vectorized,  # jnp.maximum is batch-native already
    )

    kernel.single(Q_copy[0], Q[0])
    kernel.directional(Flux(Q_copy[0], normal, tmp_flux[0]))
    kernel.directional(tmp_eig[0], Eigen(Q_copy[0], normal))
    kernel.directional(Q_copy[0], Q_copy[0] + 0.5 * (tmp_flux[-1] - tmp_flux[1]))

    left = -Max(tmp_eig[-1], tmp_eig[0]) * (Q[0] - Q[-1])
    right = -Max(tmp_eig[1], tmp_eig[0]) * (Q[0] - Q[1])
    kernel.directional(Q_copy[0], Q_copy[0] + 0.5 * dt * (left - right), struct=True)

    kernel.single(Q[0], Q_copy[0])
    return kernel
