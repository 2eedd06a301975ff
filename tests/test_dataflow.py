"""Transitive spatial dataflow analysis (frontend/dataflow.py).

Covers the two failure modes the per-statement bounds view cannot see:

- refluxing applied to reconstruction-based specs (the Berger–Colella
  correction is only consistent with first-order Rusanov face fluxes);
- chained multi-stage stencil reach exceeding the stored halo (interior
  cells silently computed from never-written scratch).
"""

import numpy as np
import pytest
import sympy

from exahype_jax.frontend.dataflow import (
    max_input_reach,
    transitive_input_reach,
    validate_dataflow,
)
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.models.muscl import build_muscl_kernel
from exahype_jax.models.rusanov import build_rusanov_kernel
from exahype_jax.utils.errors import LoweringError, SemanticError


def test_rusanov_reach_is_one():
    kb = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=4,
                              n_aux=0, n_patches=2)
    reach = transitive_input_reach(kb)
    assert max_input_reach(kb) == 1
    for neg, pos in reach.values():
        assert (neg, pos) == (1, 1)


def test_muscl_reach_exceeds_one():
    kb = build_muscl_kernel(dim=2, patch_size=4, halo_size=2, n_real=4,
                            n_aux=0, n_patches=2)
    assert max_input_reach(kb) >= 2


def test_reflux_probe_rejects_reconstruction_specs():
    """The advisor's scenario: MUSCL satisfies the Flux/maxEigenvalue probe
    but its face fluxes use limited reconstruction — refluxing must
    auto-disable, not silently apply an inconsistent correction."""
    from exahype_jax.parallel.refine import reflux_physics

    first_order = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1,
                                       n_real=4, n_aux=0, n_patches=4)
    assert reflux_physics(first_order) is not None

    muscl = build_muscl_kernel(dim=2, patch_size=4, halo_size=2, n_real=4,
                               n_aux=0, n_patches=4)
    assert reflux_physics(muscl) is None


def test_pool_autodisables_reflux_for_muscl():
    from exahype_jax.parallel.grid import PatchGrid
    from exahype_jax.parallel.pool import PatchPoolRefinement
    from exahype_jax.parallel.solver import GridSolver
    from exahype_jax.utils.config import KernelConfig

    cfg = KernelConfig(dim=2, patch_size=4, halo_size=2, n_real=4, n_aux=0,
                       n_patches=9)
    grid = PatchGrid(config=cfg, grid_shape=(3, 3))
    kb = build_muscl_kernel(dim=2, patch_size=4, halo_size=2, n_real=4,
                            n_aux=0, n_patches=9)
    pool = PatchPoolRefinement(
        GridSolver(grid, kb, dx=0.1, kernel_dt="lambda"), capacity=2,
        factor=2,
    )
    assert pool._physics() is None  # reflux silently but LOUDLY off


def _chained_kernel(halo_size: int) -> KernelBuilder:
    """Two chained central-difference stages: total reach 2."""
    kb = KernelBuilder(dim=2, patch_size=4, halo_size=halo_size, n_real=3,
                       n_aux=0, n_patches=2)
    Q = kb.item("Q")
    s = kb.directional_item("s")
    t = kb.directional_item("t")
    Qc = kb.item("Q_copy")
    kb.single(Qc[0], Q[0])
    kb.directional(s[0], Q[1] - Q[-1])
    kb.directional(t[0], s[1] - s[-1])
    kb.directional(Qc[0], Qc[0] + t[0])
    kb.single(Q[0], Qc[0])
    return kb


def test_validate_dataflow_accepts_sufficient_halo():
    validate_dataflow(_chained_kernel(halo_size=2), policy="sound")
    validate_dataflow(
        build_muscl_kernel(dim=2, patch_size=4, halo_size=2, n_real=4,
                           n_aux=0, n_patches=2),
        policy="sound",
    )


def test_validate_dataflow_rejects_chained_reach_beyond_halo():
    kb = _chained_kernel(halo_size=1)
    with pytest.raises(LoweringError, match="chained stencil reach"):
        validate_dataflow(kb, policy="sound")


def test_validate_dataflow_runs_in_jax_backend():
    from exahype_jax.backends.jax_backend import JAXPrinter

    with pytest.raises(LoweringError, match="chained stencil reach"):
        JAXPrinter(_chained_kernel(halo_size=1)).build()


def test_golden_policy_skips_validation():
    # The reference-parity policies intentionally read zero-initialized
    # temps; validation must not reject them.
    validate_dataflow(_chained_kernel(halo_size=1), policy="golden")


def test_native_driver_rejects_config_mismatch():
    from exahype_jax.backends.cpp_runtime import NativeGridDriver
    from exahype_jax.parallel.grid import PatchGrid
    from exahype_jax.utils.config import KernelConfig

    cfg = KernelConfig(dim=2, patch_size=4, halo_size=1, n_real=4, n_aux=0,
                       n_patches=4)
    grid = PatchGrid(config=cfg, grid_shape=(2, 2))
    # Kernel built for MORE patches than the grid: native code would write
    # past the state buffer; must fail in Python instead.
    kb = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=4,
                              n_aux=0, n_patches=16)
    with pytest.raises(SemanticError, match="does not match grid config"):
        NativeGridDriver(grid, kb, dx=0.1)
