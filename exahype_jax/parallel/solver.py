"""Grid solver: the time-integration driver over a patch grid.

Combines the pieces the reference leaves to the downstream ExaHyPE2/Peano
framework (time stepping, halo exchange, adaptive dt — visible only through
the headers the CPPPrinter emits, ``exahype/printers/CPPPrinter.py:321-347``)
into a jittable step:

    halo_fill (neighbour exchange, collectives under sharding)
      → patch-update kernel (vectorized over the flattened patch axis)
      → optional CFL dt from the global max wave speed (all-reduce)

The kernel is lowered by ``JAXPrinter`` over an AoS :class:`PatchGrid`.
``run`` integrates with ``lax.scan`` so the whole time loop is one XLA
program (no per-step host round trips).
"""

from __future__ import annotations

from typing import Callable, Literal, Optional

import jax
import jax.numpy as jnp

from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.parallel.grid import PatchGrid
from exahype_jax.utils.errors import SemanticError


class GridSolver:
    """Drives a patch-update kernel over a patch grid.

    ``eigenvalue_fn(interior) -> wave speeds`` (same layout as the grid
    state) enables CFL-controlled adaptive dt; omit it for fixed-dt stepping.
    """

    def __init__(
        self,
        grid: PatchGrid,
        kernel: KernelBuilder,
        dx: float = 1.0,
        cfl: float = 0.45,
        eigenvalue_fn: Optional[Callable] = None,
        kernel_dt: Literal["physical", "lambda"] = "physical",
        **backend_kwargs,
    ):
        self.grid = grid
        self.kernel = kernel
        self.dx = dx
        self.cfl = cfl
        self.eigenvalue_fn = eigenvalue_fn
        #: What the kernel's scalar argument means: the physical dt (the
        #: canonical reference spec) or λ = dt/dx (the corrected scaled
        #: spec, models/fv.py) — the solver converts accordingly.
        self.kernel_dt = kernel_dt
        if not isinstance(grid, PatchGrid):
            raise SemanticError("GridSolver drives an AoS PatchGrid")
        from exahype_jax.backends.jax_backend import JAXPrinter

        self._kernel_fn = JAXPrinter(kernel, **backend_kwargs).build()

    # ------------------------------------------------------------------ step

    def step(self, Q, dt):
        """One halo-exchange + patch-update step on grid-shaped state."""
        kdt = dt / self.dx if self.kernel_dt == "lambda" else dt
        dt = kdt
        Q = self.grid.halo_fill(Q)
        Qb = self.grid.to_batched(Q)
        Qb = self._kernel_fn(Qb, dt)
        return self.grid.from_batched(Qb)

    def _interior(self, Q):
        cfg = self.grid.config
        h = cfg.halo_size
        out = Q
        for d in range(cfg.dim):
            ax = cfg.dim + d
            sl = [slice(None)] * Q.ndim
            sl[ax] = slice(h, h + cfg.patch_size)
            out = out[tuple(sl)]
        return out

    def compute_dt(self, Q):
        """CFL time step from the global maximum wave speed (all-reduce
        under sharding)."""
        if self.eigenvalue_fn is None:
            raise ValueError("GridSolver needs eigenvalue_fn for adaptive dt")
        lam = jnp.max(self.eigenvalue_fn(self._interior(Q)))
        return self.cfl * self.dx / lam

    def run(self, Q, n_steps: int, dt=None):
        """Integrate ``n_steps`` with ``lax.scan``; returns (state, t).

        Fixed ``dt`` if given, else adaptive CFL dt each step.
        """

        def body(carry, _):
            Q, t = carry
            step_dt = self.compute_dt(Q) if dt is None else dt
            Qn = self.step(Q, step_dt)
            return (Qn, t + step_dt), None

        (Qf, tf), _ = jax.lax.scan(
            body, (Q, jnp.asarray(0.0, Q.dtype)), None, length=n_steps
        )
        return Qf, tf
