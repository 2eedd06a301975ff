"""Second-order MUSCL FV kernel, authored entirely in the spec DSL.

The reference's canonical spec is the first-order Rusanov patch update
(``examples/Batched_stateless.py``).  This module demonstrates that the
same ``KernelBuilder`` language expresses a genuinely higher-order scheme:
unsplit MUSCL — minmod-limited linear reconstruction per direction, face
Rusanov fluxes of the reconstructed states, conservative update — using
nothing beyond the DSL's statement vocabulary:

- the slope limiter needs no conditionals:
  ``minmod(a, b) = Max(0, Min(a, b)) + Min(0, Max(a, b))``
  (exact for all sign combinations), expressed with SymPy ``Max``/``Min``
  which every backend lowers natively;
- reconstruction reads one extra neighbour ring, so ``halo_size=2`` — the
  bounds machinery derives all loop regions from the offsets;
- face fluxes use the physics callbacks on RECONSTRUCTED states (two
  ``Flux``/``maxEigenvalue`` calls per direction), the same typed-function
  contract as the first-order kernel.

Spatial order 2 (convergence-tested with dt ∝ dx² so the forward-Euler
time error stays subdominant); conservative by flux form.
"""

from __future__ import annotations

from typing import Callable, Optional

from sympy import Max, Min
from sympy.codegen.ast import integer, real

from exahype_jax.frontend.kernel_builder import KernelBuilder


def build_muscl_kernel(
    dim: int = 2,
    patch_size: int = 4,
    halo_size: int = 2,
    n_real: int = 5,
    n_aux: int = 0,
    n_patches: int = 1,
    flux_impl: Optional[Callable] = None,
    eigenvalue_impl: Optional[Callable] = None,
    limiter: str = "minmod",
) -> KernelBuilder:
    """Unsplit MUSCL patch update; kernel scalar = λ = dt/dx.

    ``limiter``: "minmod" (TVD, the robust default — L1 order ≈ 5/3 on
    smooth data, the known clipped-extrema value) or "central" (unlimited
    ½(Q₊−Q₋) slope — clean 2nd order, for smooth problems / convergence
    studies only)."""
    if halo_size < 2:
        raise ValueError("MUSCL reconstruction needs halo_size >= 2")
    from exahype_jax.models.fv import resolve_physics_impls

    flux_impl, eigenvalue_impl = resolve_physics_impls(
        dim, n_real, flux_impl, eigenvalue_impl
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
    slope = kernel.directional_item("slope")
    qL = kernel.directional_item("q_lo")   # left  face value of each cell
    qR = kernel.directional_item("q_hi")   # right face value of each cell
    fL = kernel.directional_item("f_lo")
    fR = kernel.directional_item("f_hi")
    eigL = kernel.directional_item("eig_lo", struct=False)
    eigR = kernel.directional_item("eig_hi", struct=False)
    fhat = kernel.directional_item("fhat")
    lam = kernel.const("dt")  # λ = dt/dx
    kernel.directional_const("normal", list(range(dim)))
    normal = kernel.all_items["normal"]

    Flux = kernel.function(
        "Flux",
        parameter_types=[Q, real, Q],
        return_type=integer,
        jax_impl=flux_impl,
        out_param=2,
        vectorized=True,
    )
    Eigen = kernel.function(
        "maxEigenvalue",
        parameter_types=[Q, real],
        return_type=real,
        jax_impl=eigenvalue_impl,
        vectorized=True,
    )

    if limiter not in ("minmod", "central"):
        raise ValueError(f"unknown limiter {limiter!r}")

    kernel.single(Q_copy[0], Q[0])

    a = Q_copy[0] - Q_copy[-1]
    b = Q_copy[1] - Q_copy[0]
    if limiter == "minmod":
        # Minmod without conditionals: Max(0, Min(a,b)) + Min(0, Max(a,b)).
        kernel.directional(slope[0], Max(0, Min(a, b)) + Min(0, Max(a, b)))
    else:
        kernel.directional(slope[0], 0.5 * (a + b))

    # Linear reconstruction to the two cell faces.
    kernel.directional(qR[0], Q_copy[0] + 0.5 * slope[0])
    kernel.directional(qL[0], Q_copy[0] - 0.5 * slope[0])

    # Physics of the reconstructed states.
    kernel.directional(Flux(qR[0], normal, fR[0]))
    kernel.directional(Flux(qL[0], normal, fL[0]))
    kernel.directional(eigR[0], Eigen(qR[0], normal))
    kernel.directional(eigL[0], Eigen(qL[0], normal))

    # Rusanov flux at each cell's HIGH face: left state = my right-face
    # reconstruction, right state = my +1 neighbour's left-face one.
    kernel.directional(
        fhat[0],
        0.5 * (fR[0] + fL[1])
        - 0.5 * Max(eigR[0], eigL[1]) * (qL[1] - qR[0]),
        struct_override=1,
    )

    # Conservative update from the two face fluxes.
    kernel.directional(
        Q_copy[0],
        Q_copy[0] + lam * (fhat[-1] - fhat[0]),
        struct_override=1,
    )

    kernel.single(Q[0], Q_copy[0])
    return kernel
