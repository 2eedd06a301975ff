"""Point sources: Dirac-delta forcing with a source-time function.

The flagship ExaHyPE seismic runs (the ExaSeis demonstrator family) drive
the elastic-wave system with *point sources* — a Ricker wavelet ψ(t)
multiplying δ(x − x₀), e.g. a moment-tensor point force at the epicentre.
The reference DSL repo contains no source machinery (it is the kernel
compiler prototype); this module supplies the capability with static shapes:

- the delta is represented by its **nodal coefficients under the solver's
  diagonal mass matrix** (Gauss-Legendre, or the lumped Gauss-Lobatto
  mass when ``basis="lobatto"``): per axis ℓ_i(ξ₀)/(w_i·dx).  This is the
  exact weak-form projection — testing the deposit against any polynomial
  up to the scheme's degree reproduces point evaluation (the duality
  property, tested);
- deposition is a scatter-add of an ``[S, nodes.., V]`` block into the
  owning cells — static shapes, any number of sources, jittable;
- time integration is **split-step (Strang)**: half the time-integrated
  wavelet is injected before the solver step and half after.  (ExaHyPE2
  evaluates point sources inside the ADER predictor; the split form keeps
  the solver step source-free — so it composes unchanged with the fused
  GPU cell stage, the limiter, and the sharded paths — at the same
  second-order splitting accuracy.)  The wavelet integral
  ∫ψ over each (half-)interval is taken by Gauss-Legendre quadrature of
  the scheme's order, so smooth wavelets integrate to quadrature accuracy
  and the total injected quantity matches ∫ψ·amplitude exactly for
  polynomial ψ (tested: total momentum injected into the elastic system).

Positions, amplitudes and the wavelet are data, not trace constants —
moving a source or re-scaling it never retraces the step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.models.tracers import _lagrange_basis
from exahype_jax.utils.errors import SemanticError


def ricker(f0: float, t_delay: float | None = None):
    """Ricker (Mexican-hat) wavelet of peak frequency ``f0`` — the standard
    seismic source-time function.  Default delay centres the wavelet at
    1/f0 so it starts near zero."""
    if t_delay is None:
        t_delay = 1.0 / f0

    def psi(t):
        a = (jnp.pi * f0 * (t - t_delay)) ** 2
        return (1.0 - 2.0 * a) * jnp.exp(-a)

    return psi


@dataclasses.dataclass(frozen=True)
class PointSources:
    """A set of delta sources for an SoA-P-layout DG solver.

    Parameters
    ----------
    solver:
        `ADERDGSolver` (or a fused accelerator via ``.solver``).
    positions:
        ``[n_sources, dim]`` physical source locations.
    amplitudes:
        ``[n_sources, n_vars]`` per-variable strengths (e.g. a force on
        the velocity components of the elastic system).
    wavelet:
        ``psi(t) -> scalar or [n_sources]`` source-time function, traced.
    """

    solver: object
    positions: object
    amplitudes: object
    wavelet: Callable

    def __post_init__(self):
        solver = getattr(self.solver, "solver", self.solver)
        object.__setattr__(self, "solver", solver)
        pos = jnp.asarray(self.positions)
        amp = jnp.asarray(self.amplitudes)
        if pos.ndim != 2 or pos.shape[1] != solver.dim:
            raise SemanticError(
                f"positions must be [n_sources, {solver.dim}], got {pos.shape}"
            )
        if amp.shape != (pos.shape[0], solver.n_vars):
            raise SemanticError(
                f"amplitudes must be [{pos.shape[0]}, {solver.n_vars}], "
                f"got {amp.shape}"
            )
        object.__setattr__(self, "positions", pos)
        object.__setattr__(self, "amplitudes", amp)
        # The solver's own nodal basis (Legendre or Lobatto): the delta
        # deposit divides by the solver's DIAGONAL mass weights, so the
        # weak identity holds in the solver's discrete inner product.
        nodes = np.asarray(solver.ops.nodes)
        weights = np.asarray(solver.ops.weights)
        object.__setattr__(self, "_nodes", nodes)
        object.__setattr__(self, "_weights", weights)

    # ------------------------------------------------------------ deposit

    def delta_field(self, dtype, scale=None):
        """The nodal representation of Σ_s scale_s·amp_s·δ(x−x_s): an array
        of the solver's state shape whose weak inner product with any test
        polynomial up to the scheme's degree equals point evaluation.
        ``scale`` is an optional per-source factor (scalar or
        ``[n_sources]``)."""
        solver = self.solver
        dim, n = solver.dim, solver.n_nodes
        n_src = self.positions.shape[0]
        pos = self.positions.astype(dtype)
        dxs = jnp.asarray(solver._dxs, dtype)
        s = pos / dxs
        c = jnp.floor(s)
        xi = s - c
        g = jnp.asarray(solver.grid_shape, jnp.int32)
        c = jnp.mod(c.astype(jnp.int32), g)
        # Per-source nodal block: Π_d ℓ_i(ξ_d) / (w_i · dx_d)   [S, n^dim]
        blocks = None
        for d in range(dim):
            b = _lagrange_basis(self._nodes, xi[:, d]).astype(dtype)
            b = b / (jnp.asarray(self._weights, dtype) * dxs[d])
            b = b.reshape((n_src,) + (1,) * d + (n,) + (1,) * (dim - 1 - d))
            blocks = b if blocks is None else blocks * b
        amp = self.amplitudes.astype(dtype)
        if scale is not None:
            amp = amp * jnp.reshape(
                jnp.asarray(scale, dtype) * jnp.ones((n_src,), dtype),
                (n_src, 1),
            )
        # [S, n^dim, V]
        blocks = blocks[..., None] * amp.reshape(
            (n_src,) + (1,) * dim + (solver.n_vars,)
        )
        flat = c[:, 0]
        for d in range(1, dim):
            flat = flat * solver.grid_shape[d] + c[:, d]
        out = jnp.zeros(
            (n,) * dim + (solver.n_vars, int(np.prod(solver.grid_shape))),
            dtype,
        )
        # Scatter-add each source block into its cell.
        out = out.at[..., flat].add(jnp.moveaxis(blocks, 0, -1))
        return out.reshape(solver.state_shape)

    # ------------------------------------------------------------- wavelet

    def _integrate_wavelet(self, t0, dt):
        """∫_{t0}^{t0+dt} ψ — Gauss-Legendre of the scheme's order (exact
        for polynomial ψ of degree ≤ 2·order+1).  ψ may return a scalar
        (shared wavelet) or ``[n_sources]``."""
        tq = t0 + jnp.asarray(self._nodes, jnp.result_type(t0)) * dt
        wq = jnp.asarray(self._weights, jnp.result_type(t0))
        vals = jax.vmap(self.wavelet)(tq)
        return dt * jnp.tensordot(wq, vals, axes=([0], [0]))

    # --------------------------------------------------------------- steps

    def inject(self, u, t0, dt):
        """Add the time-integrated sources over [t0, t0+dt] to the state."""
        w = self._integrate_wavelet(t0, dt)
        return u + self.delta_field(u.dtype, scale=w)

    def step(self, u, t0, dt, step_fn=None):
        """One Strang-split forced step: inject [t0, t0+dt/2], advance the
        homogeneous solver, inject [t0+dt/2, t0+dt].  ``step_fn(u, dt)``
        defaults to the solver's own step."""
        if step_fn is None:
            step_fn = self.solver.step
        u = self.inject(u, t0, 0.5 * dt)
        u = step_fn(u, dt)
        return self.inject(u, t0 + 0.5 * dt, 0.5 * dt)

    def run(self, u, t0, dt, n_steps: int, step_fn=None):
        """Scan ``n_steps`` forced steps; returns (u, t)."""

        def body(carry, _):
            u, t = carry
            return (self.step(u, t, dt, step_fn), t + dt), None

        (u_out, t_out), _ = jax.lax.scan(
            body, (u, jnp.asarray(t0, u.dtype)), None, length=n_steps
        )
        return u_out, t_out
