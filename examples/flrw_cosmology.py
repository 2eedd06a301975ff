"""Coupled matter + dynamic spacetime: an expanding FLRW universe.

The ExaGRyPE flagship shape (FO-Z4 Einstein equations + GRHD evolved
TOGETHER, `models/z4_matter.py`) on the one cosmological configuration
with a machine-precision independent reference: a flat
Friedmann-Lemaitre-Robertson-Walker universe filled with a Γ-law
perfect fluid.  The full 43-variable nonlinear coupled PDE system on
homogeneous data reduces to the Friedmann ODEs — this example evolves
it with the production ADER-DG solver and compares the scale factor
(via γ_xx), the extrinsic curvature, and the conserved baryon density
against an independent RK4 integration of the Friedmann system, and
prints the Z4 constraint-sector norms (Θ, Z_i stay at rounding when
the constraints are preserved).

Run: python examples/flrw_cosmology.py [--cpu]
"""

import sys

import jax

if "--cpu" in sys.argv or __name__ != "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np

from exahype_jax.models.z4 import N_VARS as N_Z4
from exahype_jax.models.z4_matter import (
    flrw_reference,
    flrw_state,
    make_z4_matter_solver,
)

GAMMA = 5.0 / 3.0
RHO0 = 0.02
EPS0 = 0.4
T_END = 0.5
N_STEPS = 100


def main():
    solver = make_z4_matter_solver(
        dim=2, order=2, grid_shape=(4, 4), dx=0.25,
        gamma=GAMMA, slicing="harmonic", f=0.0,  # geodesic slicing
    )
    adot0 = float(np.sqrt(8 * np.pi * RHO0 * (1 + EPS0) / 3))
    Q = flrw_state(solver, 1.0, adot0, rho0=RHO0, eps0=EPS0, gamma=GAMMA)
    Q = solver.run(Q, N_STEPS, T_END / N_STEPS)

    a_ref, adot_ref = flrw_reference(T_END, rho0=RHO0, eps0=EPS0,
                                     gamma=GAMMA)
    q = np.moveaxis(np.asarray(Q), solver.var_axis, -1)
    gxx = float(q[..., 1].ravel()[0])
    Kxx = float(q[..., 7].ravel()[0])
    Dt = float(q[..., N_Z4].ravel()[0])
    th = float(np.abs(q[..., 13]).max())
    Zmax = float(np.abs(q[..., 14:17]).max())

    print(f"t = {T_END}: scale factor a (solver) = {np.sqrt(gxx):.10f}")
    print(f"             scale factor a (Friedmann reference) = {a_ref:.10f}")
    print(f"rel error a²: {abs(gxx - a_ref**2)/a_ref**2:.2e}")
    print(f"rel error K_xx: {abs(Kxx + a_ref*adot_ref)/abs(a_ref*adot_ref):.2e}")
    print(f"baryon D-tilde drift: {abs(Dt - RHO0)/RHO0:.2e} (exact conservation)")
    print(f"constraint sector: |Theta| = {th:.2e}, |Z| = {Zmax:.2e}")
    assert abs(gxx - a_ref**2) / a_ref**2 < 1e-7
    assert abs(Dt - RHO0) / RHO0 < 1e-9
    assert th < 1e-9 and Zmax < 1e-9
    print("coupled Z4+GRHD FLRW: matches the Friedmann reference")


if __name__ == "__main__":
    main()
