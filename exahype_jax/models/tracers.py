"""Tracer particles: Lagrangian probes advected through the DG solution.

The downstream ExaHyPE2 framework ships a particle toolbox whose flagship
use is *tracers* — massless particles advected with the flow that record
the solution along their trajectories (astrophysics post-processing,
e.g. neutron-star-merger nucleosynthesis tracers).  The reference DSL
repo itself contains no particle code (it is the kernel-compiler
prototype; SURVEY.md §0), so this module is capability depth beyond the
reference, with static shapes:

- particle state is a dense ``[n_particles, dim]`` position array —
  static shapes, no host round-trips, jit/scan/shard-compatible;
- locating the owning cell is pure arithmetic (floor divide), and
  reading its ``(order+1)^dim`` nodal values is ONE flat gather along the
  trailing grid axes of the SoA-P state layout;
- evaluating the DG polynomial at the particle's local coordinate is a
  per-particle Lagrange-basis contraction — tiny einsums batched over
  the particle axis;
- time integration is explicit RK2 (midpoint), so a tracer step composes
  with the solver step inside one ``lax.scan`` with no retracing.

Interpolation uses the owning cell's polynomial only (DG solutions are
discontinuous across faces; single-cell evaluation is the standard tracer
choice and is exact for polynomials up to the scheme's order — tested).

Works against any solver exposing the SoA-P layout contract
(``state_shape = nodes^dim + (n_vars,) + grid_shape`` with
``var_axis = dim``): `ADERDGSolver`, `TritonADERDG` (via ``.solver``),
and the limiter's candidate states.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.utils.errors import SemanticError

#: Every einsum of state at HIGHEST precision (see models/aderdg.py).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def _lagrange_basis(nodes: np.ndarray, xi):
    """``B[p, i] = ℓ_i(xi_p)`` for traced local coordinates ``xi`` ∈ [0,1].

    Static double loop over the (order+1) basis — unrolls to a handful of
    fused multiply-adds per particle.
    """
    n = len(nodes)
    cols = []
    for i in range(n):
        term = jnp.ones_like(xi)
        for j in range(n):
            if j != i:
                term = term * (xi - nodes[j]) / (nodes[i] - nodes[j])
        cols.append(term)
    return jnp.stack(cols, axis=-1)


def euler_velocity(dim: int):
    """``velocity_fn`` for compressible Euler: v = momentum / density."""

    def velocity(vals):
        return vals[:, 1 : 1 + dim] / vals[:, 0:1]

    return velocity


@dataclasses.dataclass(frozen=True)
class TracerAdvector:
    """Samples and advects tracer particles through a DG solution.

    Parameters
    ----------
    solver:
        Any SoA-P-layout DG solver (``dim``, ``order``/``n_nodes``,
        ``n_vars``, ``grid_shape``, per-axis ``dx``).  `TritonADERDG`
        accelerators are unwrapped via their ``.solver`` attribute.
    velocity_fn:
        ``vals[P, n_vars] -> v[P, dim]`` — the advecting velocity from
        sampled solution values (:func:`euler_velocity` for Euler).
    boundary:
        ``"periodic"`` wraps positions across the domain;
        ``"clamp"`` clips them to the domain interior (wall boundaries —
        with reflective walls the normal velocity vanishes at the wall, so
        clamping only absorbs the O(dt²) integrator overshoot).
    """

    solver: object
    velocity_fn: Callable
    boundary: str = "periodic"

    def __post_init__(self):
        solver = getattr(self.solver, "solver", self.solver)
        object.__setattr__(self, "solver", solver)
        if self.boundary not in ("periodic", "clamp"):
            raise SemanticError(
                f"boundary must be 'periodic' or 'clamp', got {self.boundary!r}"
            )
        if solver.var_axis != solver.dim:
            raise SemanticError(
                "TracerAdvector requires the SoA-P layout "
                "(node axes, var axis, grid axes)"
            )
        nodes = np.asarray(solver.ops.nodes)  # solver's basis (GL/Lobatto)
        object.__setattr__(self, "_nodes", nodes)

    # ------------------------------------------------------------- geometry

    @property
    def dim(self) -> int:
        return self.solver.dim

    @property
    def extents(self) -> tuple[float, ...]:
        """Physical domain size per axis (grid cells × cell width)."""
        return tuple(
            g * d for g, d in zip(self.solver.grid_shape, self.solver._dxs)
        )

    def _wrap(self, x):
        ext = jnp.asarray(self.extents, x.dtype)
        if self.boundary == "periodic":
            return jnp.mod(x, ext)
        # Clamp strictly inside so floor() lands on a real cell.
        eps = jnp.asarray(
            [np.finfo(np.float32).eps * e for e in self.extents], x.dtype
        )
        return jnp.clip(x, 0.0, ext - eps)

    def _locate(self, x):
        """Owning cell indices ``[P, dim]`` (int32) and local coords ξ ∈
        [0,1] ``[P, dim]``."""
        dxs = jnp.asarray(self.solver._dxs, x.dtype)
        s = x / dxs
        c = jnp.floor(s)
        xi = s - c
        g = jnp.asarray(self.solver.grid_shape, jnp.int32)
        c = c.astype(jnp.int32)
        if self.boundary == "periodic":
            c = jnp.mod(c, g)
        else:
            c = jnp.clip(c, 0, g - 1)
        return c, xi

    # ------------------------------------------------------------- sampling

    def sample(self, u, x):
        """Evaluate the DG solution at positions ``x[P, dim]`` → ``[P, n_vars]``.

        One flat gather over the trailing grid axes (the particle axis
        last), then per-axis Lagrange contractions.
        """
        solver = self.solver
        # Normalize into the domain first so clamp mode lands on the edge
        # CELL with xi at the edge (not an interior cell with xi=0).
        c, xi = self._locate(self._wrap(jnp.asarray(x)))
        # Flat cell index over the trailing grid axes.
        flat = c[:, 0]
        for d in range(1, self.dim):
            flat = flat * solver.grid_shape[d] + c[:, d]
        outer = u.shape[: self.dim + 1]  # node axes + var axis
        uf = u.reshape(outer + (-1,))
        qc = jnp.take(uf, flat, axis=-1)  # [n.., V, P]
        basis = [
            _lagrange_basis(self._nodes, xi[:, d]).astype(u.dtype)
            for d in range(self.dim)
        ]
        if self.dim == 1:
            return _einsum("pa,avp->pv", basis[0], qc)
        if self.dim == 2:
            return _einsum("pa,pb,abvp->pv", basis[0], basis[1], qc)
        return _einsum(
            "pa,pb,pc,abcvp->pv", basis[0], basis[1], basis[2], qc
        )

    # ------------------------------------------------------------ advection

    def velocity(self, u, x):
        """Advecting velocity at positions ``x`` → ``[P, dim]``."""
        return self.velocity_fn(self.sample(u, x))

    def advect(self, u, x, dt):
        """One RK2 (midpoint) advection step through the frozen field ``u``.

        Second order in dt for the trajectory ODE; the field itself is the
        start-of-step solution (the standard tracer-toolbox choice — the
        field error enters at the same O(dt²) as the integrator's).
        """
        x = jnp.asarray(x)
        v1 = self.velocity(u, x)
        xm = self._wrap((x + (0.5 * dt) * v1).astype(x.dtype))
        v2 = self.velocity(u, xm)
        return self._wrap((x + dt * v2).astype(x.dtype))

    # ------------------------------------------------------------ recording

    def trajectories(self, step_fn, u, x, dt, n_steps: int):
        """Advance solver + tracers together; record the time series.

        ``step_fn(u, dt) -> u'`` is the solver step (e.g.
        ``solver.step`` or a limited/fused step).  Tracers advect through
        the start-of-step field, then the field advances — one fused
        ``lax.scan``, no host round-trips.

        Returns ``(u_final, x_final, xs[n_steps, P, dim],
        vals[n_steps, P, n_vars])`` — positions and sampled solution
        AFTER each step (through the pre-step field, the value the tracer
        "saw" while moving).
        """

        def body(carry, _):
            u, x = carry
            x_new = self.advect(u, x, dt)
            rec = self.sample(u, x_new)
            return (step_fn(u, dt), x_new), (x_new, rec)

        (u_out, x_out), (xs, vals) = jax.lax.scan(
            body, (u, jnp.asarray(x)), None, length=n_steps
        )
        return u_out, x_out, xs, vals


def uniform_tracers(
    extents: Sequence[float], counts: Sequence[int], dtype=jnp.float32
):
    """Regular lattice of tracer seeds, cell-center style (no particles on
    the domain boundary)."""
    axes = [
        (np.arange(n) + 0.5) * (e / n) for e, n in zip(extents, counts)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return jnp.asarray(
        np.stack([g.ravel() for g in grids], axis=-1), dtype
    )


class NestedTracerAdvector:
    """Tracers over a two-level AMR composite (`ADERDGNestedRefinement`):
    particles inside the refined box sample the FINE solution, everyone
    else the coarse — the adaptive-mesh behaviour of the ExaHyPE2 tracer
    toolbox.

    State is the AMR pair ``(uc, uf)``; ``step_fn`` in
    :meth:`trajectories` is ``(state, dt) -> state`` (e.g.
    ``lambda s, dt: amr.step(*s, dt)``).  The fine sub-sampler runs in
    clamp mode on the ghost-extended fine grid; its values are selected
    only where the particle is strictly inside the refined interior.
    """

    def __init__(self, amr, velocity_fn: Callable, boundary: str = "periodic"):
        self.amr = amr
        self.coarse_adv = TracerAdvector(amr.coarse, velocity_fn, boundary)
        self.fine_adv = TracerAdvector(amr.fine, velocity_fn, "clamp")
        c = amr.coarse
        r = amr.factor
        # Physical origin of the ghost-extended fine grid: one fine cell
        # before the region's low corner.
        self._origin = tuple(
            (lo - 1.0 / r) * dxc for lo, dxc in zip(amr.region_lo, c._dxs)
        )
        self._lo = tuple(lo * dxc for lo, dxc in zip(amr.region_lo, c._dxs))
        self._hi = tuple(hi * dxc for hi, dxc in zip(amr.region_hi, c._dxs))

    @property
    def dim(self) -> int:
        return self.coarse_adv.dim

    def _inside(self, xw):
        lo = jnp.asarray(self._lo, xw.dtype)
        hi = jnp.asarray(self._hi, xw.dtype)
        return jnp.all((xw >= lo) & (xw < hi), axis=-1)

    def sample(self, state, x):
        uc, uf = state
        x = jnp.asarray(x)
        xw = self.coarse_adv._wrap(x)
        vals_c = self.coarse_adv.sample(uc, xw)
        vals_f = self.fine_adv.sample(
            uf, xw - jnp.asarray(self._origin, x.dtype)
        )
        return jnp.where(self._inside(xw)[:, None], vals_f, vals_c)

    def velocity(self, state, x):
        return self.coarse_adv.velocity_fn(self.sample(state, x))

    def advect(self, state, x, dt):
        x = jnp.asarray(x)
        wrap = self.coarse_adv._wrap
        v1 = self.velocity(state, x)
        xm = wrap((x + (0.5 * dt) * v1).astype(x.dtype))
        v2 = self.velocity(state, xm)
        return wrap((x + dt * v2).astype(x.dtype))

    def trajectories(self, step_fn, state, x, dt, n_steps: int):
        """Advance the AMR composite + tracers together (cf.
        :meth:`TracerAdvector.trajectories`)."""

        def body(carry, _):
            state, x = carry
            x_new = self.advect(state, x, dt)
            rec = self.sample(state, x_new)
            return (step_fn(state, dt), x_new), (x_new, rec)

        (state_out, x_out), (xs, vals) = jax.lax.scan(
            body, (state, jnp.asarray(x)), None, length=n_steps
        )
        return state_out, x_out, xs, vals


class FVTracerAdvector:
    """Tracers over finite-volume `PatchGrid` states — the FV counterpart
    of :class:`TracerAdvector` (ExaHyPE2's tracers run on FV solvers too).

    Sampling is multilinear interpolation of cell means between the 2^dim
    surrounding cell centres; each corner is gathered from its OWN
    patch's interior (one flat gather per corner over the
    ``[grid…, extent…, V]`` state), so no halo fill is required and the
    sampler works on raw solver output.  Exact for fields linear per
    axis (tested); RK2 advection and the scan recorder mirror the DG
    advector.
    """

    def __init__(self, grid, dx, velocity_fn: Callable,
                 boundary: str = "periodic"):
        if boundary not in ("periodic", "clamp"):
            raise SemanticError(
                f"boundary must be 'periodic' or 'clamp', got {boundary!r}"
            )
        cfg = grid.config
        self.grid = grid
        self.velocity_fn = velocity_fn
        self.boundary = boundary
        self.dim = cfg.dim
        if isinstance(dx, (tuple, list)):
            self._dxs = tuple(float(v) for v in dx)
        else:
            self._dxs = (float(dx),) * self.dim
        self._cells = tuple(
            g * cfg.patch_size for g in grid.grid_shape
        )  # global interior cells per axis

    @property
    def extents(self) -> tuple[float, ...]:
        return tuple(n * d for n, d in zip(self._cells, self._dxs))

    def _wrap(self, x):
        ext = jnp.asarray(self.extents, x.dtype)
        if self.boundary == "periodic":
            return jnp.mod(x, ext)
        eps = jnp.asarray(
            [np.finfo(np.float32).eps * e for e in self.extents], x.dtype
        )
        return jnp.clip(x, 0.0, ext - eps)

    def sample(self, Q, x):
        """Interpolated values at ``x[P, dim]`` → ``[P, n_vars]``."""
        cfg = self.grid.config
        P, h, e = cfg.patch_size, cfg.halo_size, cfg.extent
        x = self._wrap(jnp.asarray(x))
        s = x / jnp.asarray(self._dxs, x.dtype) - 0.5
        base = jnp.floor(s)
        frac = (s - base).astype(Q.dtype)
        base = base.astype(jnp.int32)
        ncell = jnp.asarray(self._cells, jnp.int32)
        flat_state = Q.reshape((-1, cfg.n_vars))
        out = None
        for corner in range(2**self.dim):
            bits = [(corner >> d) & 1 for d in range(self.dim)]
            gc = base + jnp.asarray(bits, jnp.int32)
            if self.boundary == "periodic":
                gc = jnp.mod(gc, ncell)
            else:
                gc = jnp.clip(gc, 0, ncell - 1)
            flat = None
            # patch-major then cell-major flat index, matching the
            # [grid…, extent…, V] state layout.
            for d in range(self.dim):
                pd = gc[:, d] // P
                flat = pd if flat is None else flat * self.grid.grid_shape[d] + pd
            for d in range(self.dim):
                ld = gc[:, d] % P + h
                flat = flat * e + ld
            vals = jnp.take(flat_state, flat, axis=0)  # [P, V]
            w = jnp.ones(x.shape[:1], Q.dtype)
            for d in range(self.dim):
                w = w * (frac[:, d] if bits[d] else 1.0 - frac[:, d])
            term = w[:, None] * vals
            out = term if out is None else out + term
        return out

    def velocity(self, Q, x):
        return self.velocity_fn(self.sample(Q, x))

    def advect(self, Q, x, dt):
        x = jnp.asarray(x)
        v1 = self.velocity(Q, x)
        xm = self._wrap((x + (0.5 * dt) * v1).astype(x.dtype))
        v2 = self.velocity(Q, xm)
        return self._wrap((x + dt * v2).astype(x.dtype))

    def trajectories(self, step_fn, Q, x, dt, n_steps: int):
        """Advance FV solver + tracers together (``step_fn(Q, dt) -> Q``)."""

        def body(carry, _):
            Q, x = carry
            x_new = self.advect(Q, x, dt)
            rec = self.sample(Q, x_new)
            return (step_fn(Q, dt), x_new), (x_new, rec)

        (Q_out, x_out), (xs, vals) = jax.lax.scan(
            body, (Q, jnp.asarray(x)), None, length=n_steps
        )
        return Q_out, x_out, xs, vals
