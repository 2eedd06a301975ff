"""Nested refinement for ADER-DG: a two-level cell hierarchy.

The ExaHyPE family couples its flagship ADER-DG scheme to the adaptive
Cartesian grid (delegated to Peano in the reference; the generated kernels
plug into it through the headers ``exahype/printers/CPPPrinter.py:321-347``).
This module supplies the ADER-DG counterpart of the FV hierarchy in
:mod:`exahype_jax.parallel.refine`: every shape static, the
whole coupled step jits/scans, adaptivity between chunks via
:class:`~exahype_jax.parallel.refine.DynamicRefinement`-style re-gridding.

Scheme per coarse step (factor ``r``, Peano tripartition ``r = 3``):

1. coarse ADER-DG step everywhere (region overwritten later);
2. ``r`` fine sub-steps at ``dt/r`` on the region extended by ONE ghost
   cell per side; before each sub-step the ghost ring is overwritten with
   the **polynomial prolongation** of the pre-step coarse solution (exact
   degree-N interpolation, :func:`~exahype_jax.models.dg.refine_interpolation`
   — order-preserving, unlike piecewise-constant upsampling).  The fine
   solver runs its ordinary periodic step on the extended grid; the wrap
   only corrupts the ghost cells themselves, which are re-imposed each
   sub-step and discarded at the end (boundary data is constant within a
   coarse step — first-order interface coupling in time, as in the
   reference family's standard coupling);
3. **L2 restriction** of the fine interior onto the coarse region
   (:func:`~exahype_jax.models.dg.refine_restriction`; ``R·P = I``, exact
   mean/mass preservation);
4. **refluxing**: the coarse cells just outside the region replace their
   boundary-face Rusanov flux with the substep-averaged, transversely
   L2-projected fine flux — the composite mass is conserved to rounding
   (tested).  Uses ``return_face_fluxes`` on both solvers.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.models.aderdg import ADERDGSolver
from exahype_jax.models.dg import refine_interpolation, refine_restriction
from exahype_jax.utils.errors import SemanticError

#: Every einsum of state at HIGHEST precision (see models/aderdg.py).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


@dataclasses.dataclass
class ADERDGNestedRefinement:
    """Two-level ADER-DG solver: coarse everywhere + fine cell box."""

    coarse: ADERDGSolver
    #: Half-open coarse CELL box of the refined region, per axis.
    region_lo: tuple[int, ...]
    region_hi: tuple[int, ...]
    factor: int = 3
    #: Replace the coarse boundary-face flux with the fine aggregate
    #: (restores exact conservation at the interface).
    reflux: bool = True
    #: Optional wrapper for the fine-level stepper, e.g.
    #: ``lambda s: LimitedADERDG(s)`` — shock capturing exactly where the
    #: resolution is (the production AMR configuration).  Must expose
    #: ``step(u, dt, return_face_fluxes=...)`` over the fine solver.
    fine_factory: object = None
    #: Same for the coarse level.
    coarse_factory: object = None

    def __post_init__(self):
        c = self.coarse
        if c.boundary != "periodic":
            raise SemanticError("ADER-DG refinement requires a periodic coarse solver")
        if len(self.region_lo) != c.dim or len(self.region_hi) != c.dim:
            raise SemanticError("region box must have one bound pair per axis")
        for lo, hi, g in zip(self.region_lo, self.region_hi, c.grid_shape):
            if not (0 <= lo < hi <= g):
                raise SemanticError(f"region [{lo},{hi}) outside the grid (size {g})")
            if hi - lo >= g:
                raise SemanticError(
                    "region must be strictly smaller than the grid on every "
                    "axis (the ghost ring needs coarse neighbours)"
                )
        r = self.factor
        #: Fine grid with one ghost cell per side (periphery re-imposed
        #: from the coarse prolongation each sub-step).
        self.ext_shape = tuple(
            r * (hi - lo) + 2 for lo, hi in zip(self.region_lo, self.region_hi)
        )
        self.fine = ADERDGSolver(
            dim=c.dim,
            order=c.order,
            n_vars=c.n_vars,
            grid_shape=self.ext_shape,
            flux_fn=c.flux_fn,
            max_eigenvalue_fn=c.max_eigenvalue_fn,
            dx=tuple(d / r for d in c._dxs),
            picard_iters=c.picard_iters,
            dissipation_mask=c.dissipation_mask,
            source_fn=c.source_fn,
            ncp_fn=c.ncp_fn,
        )
        self.fine_stepper = (
            self.fine_factory(self.fine) if self.fine_factory else self.fine
        )
        self.coarse_stepper = (
            self.coarse_factory(c) if self.coarse_factory else c
        )
        self._P = refine_interpolation(c.order, r, c.basis)  # [r, n_fine, n_coarse]
        self._R = refine_restriction(c.order, r, c.basis)  # [n_coarse, r, n_fine]
        # Per-axis gather maps for prolongation onto the EXT grid: ext cell
        # f covers coarse cell c_idx[f], fine subinterval k_idx[f].
        self._c_idx, self._k_idx = [], []
        for d in range(c.dim):
            g = np.arange(self.ext_shape[d]) - 1 + self.region_lo[d] * r
            self._c_idx.append(np.mod(g // r, c.grid_shape[d]))
            self._k_idx.append(np.mod(g, r))

    # -------------------------------------------------------------- coupling

    def prolong_ext(self, uc):
        """Polynomial prolongation of the coarse solution onto the extended
        fine grid (tensor-product per axis; exact on the DG space)."""
        c = self.coarse
        x = uc
        for d in range(c.dim):
            node_ax = c.node_axis(d)
            grid_ax = c.grid_axis(d)
            x = jnp.take(x, jnp.asarray(self._c_idx[d]), axis=grid_ax)
            T = jnp.asarray(self._P, x.dtype)[jnp.asarray(self._k_idx[d])]
            x = jnp.moveaxis(x, (node_ax, grid_ax), (0, 1))  # [n_j, F, ...]
            x = _einsum("fij,jf...->if...", T, x)
            x = jnp.moveaxis(x, (0, 1), (node_ax, grid_ax))
        return x

    def set_ghosts(self, uf, ghost_src):
        """Overwrite the one-cell periphery of the ext grid from the
        prolonged coarse field."""
        c = self.coarse
        nd = uf.ndim
        for d in range(c.dim):
            grid_ax = c.grid_axis(d)
            for pos in (0, self.ext_shape[d] - 1):
                sl = [slice(None)] * nd
                sl[grid_ax] = slice(pos, pos + 1)
                sl = tuple(sl)
                uf = uf.at[sl].set(ghost_src[sl])
        return uf

    def prolong_initial(self, uc):
        """Fine initial condition for the whole ext grid."""
        return self.prolong_ext(uc)

    def fine_coords(self):
        """Physical node coordinates of the EXT fine grid (one broadcastable
        array per dim, singleton var axis), aligned with the coarse domain —
        evaluate exact initial data directly at fine resolution instead of
        inheriting the coarse representation via :meth:`prolong_initial`."""
        c = self.coarse
        r = self.factor
        out = []
        for d in range(c.dim):
            g = np.arange(self.ext_shape[d]) - 1 + self.region_lo[d] * r
            coords = (np.asarray(c.ops.nodes)[:, None] + g[None, :]) / r * c._dxs[d]
            shape = [1] * (2 * c.dim + 1)
            shape[c.node_axis(d)] = c.n_nodes
            shape[c.grid_axis(d)] = self.ext_shape[d]
            out.append(coords.reshape(shape))
        return out

    def _restrict_axis(self, x, node_ax, grid_ax, n_cells):
        """Contract one axis pair (fine nodes × r subcells) with R."""
        r = self.factor
        x = x.reshape(x.shape[:grid_ax] + (n_cells, r) + x.shape[grid_ax + 1 :])
        x = jnp.moveaxis(x, (node_ax, grid_ax + 1), (0, 1))  # [n_i, r, ...]
        x = _einsum("jki,ik...->j...", jnp.asarray(self._R, x.dtype), x)
        return jnp.moveaxis(x, 0, node_ax)

    def restrict_into(self, uc, uf):
        """L2-project the fine interior onto the coarse region cells."""
        c = self.coarse
        x = uf
        nd = uf.ndim
        for d in range(c.dim):
            sl = [slice(None)] * nd
            sl[c.grid_axis(d)] = slice(1, self.ext_shape[d] - 1)
            x = x[tuple(sl)]
        for d in range(c.dim):
            x = self._restrict_axis(
                x,
                c.node_axis(d),
                c.grid_axis(d),
                self.region_hi[d] - self.region_lo[d],
            )
        region = tuple(
            [slice(None)] * (c.dim + 1)
            + [slice(lo, hi) for lo, hi in zip(self.region_lo, self.region_hi)]
        )
        return uc.at[region].set(x)

    # ------------------------------------------------------------- refluxing

    def _pool_face_transverse(self, face, d):
        """Restrict a FINE face array (ext grid) to the region's coarse
        transverse resolution: slice off ghost rows, then contract every
        transverse (node, grid) axis pair with R.

        Face layout: ``[nn^(dim-1) transverse nodes, V, *grid]``."""
        c = self.coarse
        dim = c.dim
        x = face
        nd = x.ndim
        # Ghost rows off every TRANSVERSE grid axis (axis d keeps its row).
        for e in range(dim):
            if e == d:
                continue
            sl = [slice(None)] * nd
            sl[dim + e] = slice(1, self.ext_shape[e] - 1)
            x = x[tuple(sl)]
        # Transverse node axes are 0..dim-2 (directions != d ascending).
        t = 0
        for e in range(dim):
            if e == d:
                continue
            x = self._restrict_axis(
                x, t, dim + e, self.region_hi[e] - self.region_lo[e]
            )
            t += 1
        return x

    def _apply_reflux(self, new_c, c_fluxes, f_flux_agg, dt):
        """Nodal surface correction of the coarse cells just outside the
        region: their region-boundary face flux becomes the fine aggregate."""
        c = self.coarse
        ops = c.ops
        nd = new_c.ndim
        for d in range(c.dim):
            lam = dt / c._dxs[d]
            node_ax = c.node_axis(d)
            grid_ax = c.grid_axis(d)
            face_grid_ax = grid_ax - 1  # face arrays lack node axis d
            X0, X1 = self.region_lo[d], self.region_hi[d]
            Ff_lo, Ff_hi = f_flux_agg[d]

            def coarse_face(idx):
                row = jax.lax.index_in_dim(
                    c_fluxes[d], idx % c.grid_shape[d], face_grid_ax, keepdims=True
                )
                # Restrict transverse grid axes to the region box.
                sl = [slice(None)] * row.ndim
                for e in range(c.dim):
                    if e == d:
                        continue
                    sl[c.grid_axis(e) - 1] = slice(
                        self.region_lo[e], self.region_hi[e]
                    )
                return row[tuple(sl)]

            shape_i = [1] * nd
            shape_i[node_ax] = c.n_nodes
            phi1_w = jnp.asarray(ops.phi1 / ops.weights, new_c.dtype).reshape(shape_i)
            phi0_w = jnp.asarray(ops.phi0 / ops.weights, new_c.dtype).reshape(shape_i)

            def cell_slices(cell_idx):
                sl = [slice(None)] * nd
                sl[grid_ax] = slice(cell_idx % c.grid_shape[d], cell_idx % c.grid_shape[d] + 1)
                for e in range(c.dim):
                    if e == d:
                        continue
                    sl[c.grid_axis(e)] = slice(self.region_lo[e], self.region_hi[e])
                return tuple(sl)

            # Face arrays lack node axis d and keep a size-1 face axis, so
            # expanding the node axis aligns them with the state cell slice.
            # Outside-low cell (X0-1): HIGH face (coarse face index X0-1)
            # carries −λ·(φ1/w)·F̂ in face_update ⇒ correct by −λ·(φ1/w)·ΔF.
            dlo = jnp.expand_dims(Ff_lo - coarse_face(X0 - 1), node_ax)
            new_c = new_c.at[cell_slices(X0 - 1)].add(-lam * phi1_w * dlo)
            # Outside-high cell (X1): LOW face (coarse face index X1-1)
            # carries +λ·(φ0/w)·F̂ ⇒ correct by +λ·(φ0/w)·ΔF.
            dhi = jnp.expand_dims(Ff_hi - coarse_face(X1 - 1), node_ax)
            new_c = new_c.at[cell_slices(X1)].add(lam * phi0_w * dhi)
        return new_c

    # ----------------------------------------------------------------- step

    def _fine_boundary_fluxes(self, f_fluxes):
        """(low, high) region-boundary fine fluxes pooled to coarse faces."""
        c = self.coarse
        out = []
        for d in range(c.dim):
            face = f_fluxes[d]
            face_grid_ax = c.grid_axis(d) - 1
            lo = jax.lax.index_in_dim(face, 0, face_grid_ax, keepdims=True)
            hi = jax.lax.index_in_dim(
                face, self.ext_shape[d] - 2, face_grid_ax, keepdims=True
            )
            out.append(
                (
                    self._pool_face_transverse(lo, d),
                    self._pool_face_transverse(hi, d),
                )
            )
        return out

    def step(self, uc, uf, dt):
        """One coupled step; returns ``(new_coarse, new_fine)``."""
        c = self.coarse
        r = self.factor
        if self.reflux:
            new_c, c_fluxes = self.coarse_stepper.step(
                uc, dt, return_face_fluxes=True
            )
        else:
            new_c = self.coarse_stepper.step(uc, dt)
        ghost_src = self.prolong_ext(uc)
        dt_f = dt / r

        def substep(carry, _):
            f, acc = carry
            f = self.set_ghosts(f, ghost_src)
            if self.reflux:
                f2, f_fluxes = self.fine_stepper.step(
                    f, dt_f, return_face_fluxes=True
                )
                sample = self._fine_boundary_fluxes(f_fluxes)
                acc = jax.tree.map(lambda a, b: a + b, acc, sample)
            else:
                f2 = self.fine_stepper.step(f, dt_f)
            return (f2, acc), None

        if self.reflux:
            acc0 = jax.tree.map(
                jnp.zeros_like,
                self._fine_boundary_fluxes(
                    [
                        jnp.zeros(
                            (c.n_nodes,) * (c.dim - 1) + (c.n_vars,) + self.ext_shape,
                            uf.dtype,
                        )
                        for _ in range(c.dim)
                    ]
                ),
            )
        else:
            acc0 = 0.0
        (new_f, acc), _ = jax.lax.scan(substep, (uf, acc0), None, length=r)
        new_c = self.restrict_into(new_c, new_f)
        if self.reflux:
            agg = jax.tree.map(lambda a: a / r, acc)
            new_c = self._apply_reflux(new_c, c_fluxes, agg, dt)
        return new_c, new_f

    def run(self, uc, uf, n_steps: int, dt):
        def body(carry, _):
            a, b = carry
            return self.step(a, b, dt), None

        (uc, uf), _ = jax.lax.scan(body, (uc, uf), None, length=n_steps)
        return uc, uf

    # ---------------------------------------------------------------- checks

    def composite_mass(self, uc, uf):
        """Quadrature mass of the composite solution (coarse outside +
        restricted fine inside; restriction preserves the fine mass)."""
        return self.coarse.total_mass(self.restrict_into(uc, uf))


def cell_mean_jump_indicator(solver, u, var: int = 0) -> np.ndarray:
    """Per-cell score: max absolute neighbour jump of one variable's cell
    mean (host-side NumPy; criteria run between compiled chunks)."""
    w = np.asarray(solver.ops.weights)
    means = np.asarray(u)
    for d in reversed(range(solver.dim)):
        means = np.tensordot(w, means, axes=([0], [solver.node_axis(d)]))
    g = means[var]  # [*grid]
    score = np.zeros_like(g)
    for ax in range(g.ndim):
        jump = np.abs(np.diff(g, axis=ax))
        pad_lo = [(0, 0)] * g.ndim
        pad_lo[ax] = (1, 0)
        pad_hi = [(0, 0)] * g.ndim
        pad_hi[ax] = (0, 1)
        score = np.maximum(score, np.pad(jump, pad_lo))
        score = np.maximum(score, np.pad(jump, pad_hi))
    return score


@dataclasses.dataclass
class DynamicADERDGRefinement:
    """Criteria-driven re-gridding for the ADER-DG hierarchy (the
    :class:`~exahype_jax.parallel.refine.DynamicRefinement` recipe on the
    flagship scheme): integrate jitted chunks of the coupled two-level
    step, score coarse cells on the host between chunks, move the refined
    box to the maximum, rebuild (prolonging the new region from the
    running coarse solution — which already holds the restricted fine
    state, so re-grid events conserve exactly).  Hierarchies and compiled
    chunks are cached per region box."""

    solver: ADERDGSolver
    #: ``criterion(solver, u) -> [*grid]`` per-cell score (NumPy);
    #: defaults to :func:`cell_mean_jump_indicator`.
    criterion: object = None
    #: Cell-box half width around the highest-scoring cell.
    half_width: int = 2
    factor: int = 3
    reflux: bool = True

    def __post_init__(self):
        if self.criterion is None:
            self.criterion = cell_mean_jump_indicator
        self._nested: dict[tuple, ADERDGNestedRefinement] = {}
        self._chunks: dict[tuple, object] = {}

    def pick_region(self, u):
        """Clamped cell box of ±half_width around the highest-scoring cell
        (kept strictly smaller than the grid on every axis, as the ghost
        ring requires)."""
        scores = np.asarray(self.criterion(self.solver, u))
        idx = np.unravel_index(int(np.argmax(scores)), scores.shape)
        lo, hi = [], []
        for i, g in zip(idx, self.solver.grid_shape):
            a = max(int(i) - self.half_width, 0)
            b = min(int(i) + self.half_width + 1, g)
            if b - a >= g:  # ghost ring needs at least one coarse cell
                b = a + g - 1
            lo.append(a)
            hi.append(b)
        return tuple(lo), tuple(hi)

    def nested_for(self, region) -> ADERDGNestedRefinement:
        if region not in self._nested:
            lo, hi = region
            self._nested[region] = ADERDGNestedRefinement(
                self.solver, region_lo=lo, region_hi=hi,
                factor=self.factor, reflux=self.reflux,
            )
        return self._nested[region]

    def _chunk_fn(self, region, chunk_steps: int):
        key = (region, chunk_steps)
        if key not in self._chunks:
            nested = self.nested_for(region)
            self._chunks[key] = jax.jit(
                lambda uc, uf, dt: nested.run(uc, uf, chunk_steps, dt)
            )
        return self._chunks[key]

    def run(self, uc, n_chunks: int, chunk_steps: int, dt):
        """Returns ``(uc, uf, info)`` with ``info["regions"]`` per chunk."""
        regions = []
        uf = None
        current = None
        for _ in range(n_chunks):
            region = self.pick_region(uc)
            if region != current:
                current = region
                uf = self.nested_for(region).prolong_initial(uc)
            regions.append(region)
            uc, uf = self._chunk_fn(region, chunk_steps)(uc, uf, dt)
        return uc, uf, {"regions": regions, "nested": self.nested_for(current)}
