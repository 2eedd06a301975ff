"""Static nested refinement: a two-level Cartesian patch hierarchy.

The ExaHyPE family's defining feature is the adaptive Cartesian grid (the
reference repo delegates it to Peano).  This module provides the static-shape
core of that capability in its static form: a coarse patch grid covering
the periodic domain plus a fine patch grid covering a fixed axis-aligned
sub-region at refinement factor ``r`` (Peano tripartitions: r = 3).  Every
shape is static, so the whole two-level step jits, shards, and scans like
the single-level solvers; *dynamic* refinement (criteria-driven re-gridding
between scan chunks) can reuse exactly these coupling operators.

Coupling per coarse step:

1. coarse solver step everywhere (the covered region is overwritten later);
2. ``r`` fine sub-steps at ``dt/r``; before each, fine-fine halos exchange
   normally and the region-boundary halos are overwritten with
   piecewise-constant **prolongation** of the coarse solution;
3. conservative **restriction**: fine cell means average down onto the
   coarse cells they cover.

Interface conservation: Berger–Colella **refluxing** (on by default for
flux-form specs) replaces the coarse flux through the refinement boundary
with the substep/transverse aggregate of the fine fluxes — the composite
coarse+fine mass is conserved to machine precision (tested).  Boundary
values for the fine sub-steps are constant-in-time within a coarse step
(first-order interface coupling in time).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.parallel.grid import PatchGrid
from exahype_jax.parallel.solver import GridSolver
from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.errors import SemanticError
from exahype_jax.utils.output import assemble_global, disassemble_global


def reflux_physics(kernel):
    """(Flux, maxEigenvalue) jax impls of a FIRST-ORDER flux-form spec,
    else None — the refluxing-eligibility probe shared by the box and pool
    paths.

    The Berger–Colella correction recomputes the faces' fluxes as the
    first-order Rusanov flux of the adjacent CELL VALUES, so it is only
    consistent with kernels whose face fluxes are exactly that.  A
    reconstruction-based spec (e.g. :func:`~exahype_jax.models.muscl.
    build_muscl_kernel`) carries the same Flux/maxEigenvalue callbacks but
    fluxes limited face states — applying the first-order correction to it
    drifts mass instead of conserving it.  Detection: the kernel's chained
    stencil reach on its inputs (:func:`~exahype_jax.frontend.dataflow.
    transitive_input_reach`) — first-order updates reach 1 cell, any
    reconstruction chain reaches ≥ 2 — mirroring the existing auto-disable
    behaviour for specs without the callbacks.
    """
    from exahype_jax.frontend.dataflow import max_input_reach

    fns = kernel.functions
    if "Flux" not in fns or "maxEigenvalue" not in fns:
        return None
    if max_input_reach(kernel) > 1:
        return None
    return fns["Flux"].jax_impl, fns["maxEigenvalue"].jax_impl


def rusanov_face(kernel, u_left, u_right, d):
    """Standard Rusanov face flux on var-axis-last rows (n_real comps)."""
    flux, eig = reflux_physics(kernel)
    s = jnp.maximum(eig(u_left, d), eig(u_right, d))[..., None]
    n_real = kernel.config.n_real
    return 0.5 * (flux(u_left, d) + flux(u_right, d)) - 0.5 * s * (
        u_right[..., :n_real] - u_left[..., :n_real]
    )


def advance_with_fill(solver, Q, dt, parent_fill):
    """One GridSolver step with an optional PARENT halo overwrite between
    the exchange and the kernel (the inner-level coupling both hierarchy
    kinds use)."""
    if parent_fill is None:
        return solver.step(Q, dt)
    q = parent_fill(solver.grid.halo_fill(Q))
    kdt = dt / solver.dx if solver.kernel_dt == "lambda" else dt
    qb = solver.grid.to_batched(q)
    qb = solver._kernel_fn(qb, kdt)
    return solver.grid.from_batched(qb)


@dataclasses.dataclass
class NestedRefinement:
    """Two-level solver: coarse everywhere + fine sub-region at factor ``r``.

    - ``coarse``: GridSolver over the full periodic domain.
    - ``region_lo`` / ``region_hi``: half-open coarse-PATCH index box of the
      refined region, per axis.
    - ``factor``: spatial refinement ratio (fine dx = coarse dx / factor).
    - ``fine_kernel``: KernelBuilder for the fine level (same spec, fine
      patch count); built internally from the coarse kernel via
      ``with_n_patches``.
    """

    coarse: GridSolver
    region_lo: tuple[int, ...]
    region_hi: tuple[int, ...]
    factor: int = 3
    #: Optional deeper refinement of THIS refinement's fine level (built
    #: with :meth:`nest`); the fine-state pytree becomes ``(Q, inner_state)``.
    inner: Optional["NestedRefinement"] = None
    #: Berger–Colella refluxing: replace the coarse flux through the
    #: refinement boundary with the substep/transverse aggregate of the fine
    #: fluxes, restoring global conservation at the interface.  Requires the
    #: standard flux-form spec (models/fv.py: Flux/maxEigenvalue functions,
    #: kernel_dt="lambda"); auto-disabled if the spec lacks them.
    reflux: bool = True

    def __post_init__(self):
        cfg = self.coarse.grid.config
        if not isinstance(self.coarse.grid, PatchGrid):
            raise SemanticError("NestedRefinement drives AoS PatchGrid solvers")
        if len(self.region_lo) != cfg.dim or len(self.region_hi) != cfg.dim:
            raise SemanticError("region box must have one bound pair per axis")
        for lo, hi, g in zip(self.region_lo, self.region_hi, self.coarse.grid.grid_shape):
            if not (0 <= lo < hi <= g):
                raise SemanticError(
                    f"region [{lo},{hi}) outside the coarse grid (size {g})"
                )
        r = self.factor
        fine_grid_shape = tuple(
            r * (hi - lo) for lo, hi in zip(self.region_lo, self.region_hi)
        )
        fine_cfg = dataclasses.replace(
            cfg, n_patches=int(np.prod(fine_grid_shape))
        )
        self.fine_grid = PatchGrid(config=fine_cfg, grid_shape=fine_grid_shape)
        fine_kernel = self.coarse.kernel.with_n_patches(fine_cfg.n_patches)
        self.fine = GridSolver(
            self.fine_grid,
            fine_kernel,
            dx=self.coarse.dx / r,
            cfl=self.coarse.cfl,
            eigenvalue_fn=self.coarse.eigenvalue_fn,
            kernel_dt=self.coarse.kernel_dt,
        )
        self._build_index_maps()

    # ------------------------------------------------------------- indexing

    def _build_index_maps(self):
        """Static NumPy index arrays for prolongation gathers."""
        cfg = self.coarse.grid.config
        P, h, r = cfg.patch_size, cfg.halo_size, self.factor
        self._block_idx = []  # per axis: [G_f, P+2h] fine-res global indices
        self._coarse_src = []  # per axis: extended fine-res -> coarse cell idx
        for d in range(cfg.dim):
            g_f = self.fine_grid.grid_shape[d]
            # Fine patch g, stored cell s (incl. halo): fine-res global
            # position g*P + s - h, shifted by +h into the extended frame.
            blocks = np.arange(g_f)[:, None] * P + np.arange(P + 2 * h)[None, :]
            self._block_idx.append(blocks)
            # Extended fine-res frame position e in [0, r*P*(hi-lo) + 2h):
            # physical fine cell index f = e - h + region_lo*P*r; containing
            # coarse GLOBAL cell c = floor(f / r), wrapped periodically.
            n_ext = g_f * P + 2 * h
            f = np.arange(n_ext) - h + self.region_lo[d] * P * r
            c = np.floor_divide(f, r)
            n_coarse = self.coarse.grid.grid_shape[d] * P
            self._coarse_src.append(np.mod(c, n_coarse))

    # ------------------------------------------------------------- coupling

    def prolong_halo_overwrite(self, fine_Q, coarse_Q):
        """Overwrite the fine grid's region-boundary halo slabs with
        piecewise-constant prolongation of the coarse solution."""
        cfg = self.coarse.grid.config
        dim, h = cfg.dim, cfg.halo_size
        if h == 0:
            return fine_Q
        coarse_global = _assemble_jnp(self.coarse.grid, coarse_Q)
        # Upsampled blocks: fine-with-halo value of every fine patch cell,
        # taken from the containing coarse cell.
        up = coarse_global
        for d in range(dim):
            idx = self._coarse_src[d][self._block_idx[d]]  # [G_f, P+2h]
            up = jnp.take(up, jnp.asarray(idx.reshape(-1)), axis=d)
        # up now has per-axis length G_f*(P+2h); reshape to patch blocks.
        shape = []
        for d in range(dim):
            shape += [self.fine_grid.grid_shape[d], cfg.extent]
        shape.append(cfg.n_vars)
        up = up.reshape(shape)
        order = list(range(0, 2 * dim, 2)) + list(range(1, 2 * dim, 2))
        order.append(2 * dim)
        blocks_up = jnp.transpose(up, order)  # fine state shape

        out = fine_Q
        nd = out.ndim
        for d in range(dim):
            if self._full_axis(d):
                continue  # region wraps onto itself: periodic fill is correct
            grid_ax, spat_ax = d, dim + d
            for grid_pos, spat_rng in (
                (0, (0, h)),
                (self.fine_grid.grid_shape[d] - 1, (cfg.patch_size + h, cfg.extent)),
            ):
                sl = [slice(None)] * nd
                sl[grid_ax] = slice(grid_pos, grid_pos + 1)
                sl[spat_ax] = slice(*spat_rng)
                sl = tuple(sl)
                out = out.at[sl].set(blocks_up[sl])
        return out

    def restrict(self, coarse_Q, fine_Q):
        """Average fine cell means down onto the coarse cells they cover."""
        cfg = self.coarse.grid.config
        dim, P, r = cfg.dim, cfg.patch_size, self.factor
        fine_global = _assemble_jnp(self.fine_grid, fine_Q)
        # Mean-pool by r along every axis.
        pooled = fine_global
        for d in range(dim):
            shape = pooled.shape
            new = shape[:d] + (shape[d] // r, r) + shape[d + 1 :]
            pooled = pooled.reshape(new).mean(axis=d + 1)
        coarse_global = _assemble_jnp(self.coarse.grid, coarse_Q)
        region_sl = tuple(
            slice(lo * P, hi * P)
            for lo, hi in zip(self.region_lo, self.region_hi)
        ) + (slice(None),)
        coarse_global = coarse_global.at[region_sl].set(pooled)
        return disassemble_global(self.coarse.grid, coarse_Q, coarse_global)

    def prolong_initial(self, coarse_Q):
        """Fine initial condition: piecewise-constant upsample of the coarse
        region (interiors; halos filled on first exchange)."""
        cfg = self.coarse.grid.config
        P, r = cfg.patch_size, self.factor
        coarse_global = _assemble_jnp(self.coarse.grid, coarse_Q)
        region = coarse_global[
            tuple(
                slice(lo * P, hi * P)
                for lo, hi in zip(self.region_lo, self.region_hi)
            )
        ]
        up = region
        for d in range(cfg.dim):
            up = jnp.repeat(up, r, axis=d)
        fine_Q = jnp.zeros(self.fine_grid.state_shape, coarse_Q.dtype)
        return disassemble_global(self.fine_grid, fine_Q, up)

    # ------------------------------------------------------------ hierarchy

    def nest(self, region_lo, region_hi, factor: int = 3) -> "NestedRefinement":
        """Refine a sub-box of THIS refinement's fine level, returning the
        inner :class:`NestedRefinement` (region in fine-patch indices).
        Assign it to ``self.inner`` to activate; arbitrary depth composes.
        """
        inner = NestedRefinement(
            self.fine, region_lo=region_lo, region_hi=region_hi, factor=factor
        )
        self.inner = inner
        return inner

    def init_state(self, coarse_Q):
        """Nested fine-state pytree prolonged from the coarse solution:
        ``Q`` for two levels, ``(Q, inner_state)`` for deeper hierarchies."""
        fine_Q = self.prolong_initial(coarse_Q)
        if self.inner is None:
            return fine_Q
        return (fine_Q, self.inner.init_state(fine_Q))

    def _full_axis(self, d: int) -> bool:
        return (
            self.region_lo[d] == 0
            and self.region_hi[d] == self.coarse.grid.grid_shape[d]
        )

    # ------------------------------------------------------------ refluxing

    def _physics(self):
        return reflux_physics(self.coarse.kernel)

    def _rusanov_face(self, u_left, u_right, d):
        return rusanov_face(self.coarse.kernel, u_left, u_right, d)

    def _boundary_rows(self, coarse_global, d):
        """Pre-step coarse rows adjacent to the region boundary along axis d,
        restricted to the region's transverse cells.  Returns
        (out_lo, in_lo, in_hi, out_hi) var-last row arrays."""
        cfg = self.coarse.grid.config
        P = cfg.patch_size
        n_d = coarse_global.shape[d]

        def row(idx):
            r = jnp.take(coarse_global, jnp.mod(idx, n_d), axis=d)
            # Restrict the remaining spatial axes to the region.
            sl = []
            ax = 0
            for dd in range(cfg.dim):
                if dd == d:
                    continue
                sl_dd = slice(self.region_lo[dd] * P, self.region_hi[dd] * P)
                sl.append(sl_dd)
            # r axes: spatial axes except d (in order), then V.
            full = tuple(sl) + (slice(None),)
            return r[full]

        X0 = self.region_lo[d] * P
        X1 = self.region_hi[d] * P
        return row(X0 - 1), row(X0), row(X1 - 1), row(X1)

    def _fine_boundary_rows(self, fine_Q, d):
        """Fine interior rows at the region boundary (var-last)."""
        fg = _assemble_jnp(self.fine_grid, fine_Q)
        lo = jnp.take(fg, 0, axis=d)
        hi = jnp.take(fg, fg.shape[d] - 1, axis=d)
        return lo, hi

    def _pool_transverse(self, rows):
        """Average r-blocks of fine transverse cells down to coarse cells."""
        r = self.factor
        out = rows
        for ax in range(out.ndim - 1):  # all but the var axis
            shape = out.shape
            out = out.reshape(
                shape[:ax] + (shape[ax] // r, r) + shape[ax + 1 :]
            ).mean(axis=ax + 1)
        return out

    def _upsample_transverse(self, rows):
        r = self.factor
        out = rows
        for ax in range(out.ndim - 1):
            out = jnp.repeat(out, r, axis=ax)
        return out

    def _boundary_flux_sample(self, fine_Q, coarse_Q):
        """Per-axis (low, high) region-boundary fluxes of ONE fine substep,
        pooled to coarse faces (zeros for axes the region fully wraps)."""
        cfg = self.coarse.grid.config
        cg = _assemble_jnp(self.coarse.grid, coarse_Q)
        out = []
        for d in range(cfg.dim):
            out_lo, _in_lo, _in_hi, out_hi = self._boundary_rows(cg, d)
            flo, fhi = self._fine_boundary_rows(fine_Q, d)
            if self._full_axis(d):
                pooled = self._pool_transverse(
                    jnp.zeros_like(flo[..., : cfg.n_real])
                )
                out.append((pooled, pooled))
                continue
            ghost_lo = self._upsample_transverse(out_lo)
            ghost_hi = self._upsample_transverse(out_hi)
            Ff_lo = self._rusanov_face(ghost_lo, flo, d)
            Ff_hi = self._rusanov_face(fhi, ghost_hi, d)
            out.append(
                (self._pool_transverse(Ff_lo), self._pool_transverse(Ff_hi))
            )
        return out

    def _apply_reflux(self, new_coarse, coarse_Q_pre, flux_acc, dt):
        """Correct the coarse cells just outside the region: their boundary
        face flux becomes the fine aggregate."""
        cfg = self.coarse.grid.config
        P = cfg.patch_size
        n_real = cfg.n_real
        lam = dt / self.coarse.dx
        cg_pre = _assemble_jnp(self.coarse.grid, coarse_Q_pre)
        cg = _assemble_jnp(self.coarse.grid, new_coarse)
        for d in range(cfg.dim):
            if self._full_axis(d):
                continue
            out_lo, in_lo, in_hi, out_hi = self._boundary_rows(cg_pre, d)
            Fc_lo = self._rusanov_face(out_lo, in_lo, d)
            Fc_hi = self._rusanov_face(in_hi, out_hi, d)
            Ff_lo, Ff_hi = flux_acc[d]
            n_d = cg.shape[d]
            X0 = self.region_lo[d] * P
            X1 = self.region_hi[d] * P

            def fix(cg, idx, delta):
                idx = int(idx) % n_d
                row = jnp.take(cg, idx, axis=d)
                sl = []
                for dd in range(cfg.dim):
                    if dd == d:
                        continue
                    sl.append(slice(self.region_lo[dd] * P, self.region_hi[dd] * P))
                full = tuple(sl) + (slice(0, n_real),)
                row = row.at[full].add(delta)
                return _set_row(cg, row, idx, d)

            # Outside-low cell's HIGH face: −λ(F_fine − F_coarse).
            cg = fix(cg, X0 - 1, -lam * (Ff_lo - Fc_lo))
            # Outside-high cell's LOW face: +λ(F_fine − F_coarse).
            cg = fix(cg, X1, lam * (Ff_hi - Fc_hi))
        return disassemble_global(self.coarse.grid, new_coarse, cg)

    # ----------------------------------------------------------------- step

    def _coarse_advance(self, coarse_Q, dt, parent_fill):
        """Advance this refinement's coarse level by dt, with the region
        boundary imposed by ``parent_fill`` when this level is itself nested."""
        return advance_with_fill(self.coarse, coarse_Q, dt, parent_fill)

    def step(self, coarse_Q, fine_state, dt, parent_fill=None):
        """One coupled step of the (sub-)hierarchy rooted here.

        ``fine_state`` is ``Q`` (two levels) or ``(Q, inner_state)`` for
        deeper nests; ``parent_fill`` imposes the parent's prolonged halos
        on this coarse level when called recursively.
        """
        new_coarse = self._coarse_advance(coarse_Q, dt, parent_fill)
        dt_f = dt / self.factor
        fill = lambda q: self.prolong_halo_overwrite(q, coarse_Q)
        do_reflux = (
            self.reflux
            and self._physics() is not None
            and self.coarse.kernel_dt == "lambda"
        )

        fine_Q0 = fine_state if self.inner is None else fine_state[0]
        if do_reflux:
            acc0 = jax.tree.map(
                jnp.zeros_like, self._boundary_flux_sample(fine_Q0, coarse_Q)
            )
        else:
            acc0 = 0.0

        if self.inner is None:

            def substep(carry, _):
                fq, acc = carry
                fq = fill(self.fine_grid.halo_fill(fq))
                if do_reflux:
                    acc = jax.tree.map(
                        lambda a, b: a + b,
                        acc,
                        self._boundary_flux_sample(fq, coarse_Q),
                    )
                fb = self.fine_grid.to_batched(fq)
                kdt = dt_f / self.fine.dx if self.fine.kernel_dt == "lambda" else dt_f
                fb = self.fine._kernel_fn(fb, kdt)
                return (self.fine_grid.from_batched(fb), acc), None

            (new_fine, acc), _ = jax.lax.scan(
                substep, (fine_state, acc0), None, length=self.factor
            )
            new_coarse = self.restrict(new_coarse, new_fine)
            if do_reflux:
                flux_agg = jax.tree.map(lambda a: a / self.factor, acc)
                new_coarse = self._apply_reflux(
                    new_coarse, coarse_Q, flux_agg, dt
                )
            return new_coarse, new_fine

        def substep(carry, _):
            (fq, inner_state), acc = carry
            if do_reflux:
                filled = fill(self.fine_grid.halo_fill(fq))
                acc = jax.tree.map(
                    lambda a, b: a + b,
                    acc,
                    self._boundary_flux_sample(filled, coarse_Q),
                )
            fq, inner_state = self.inner.step(
                fq, inner_state, dt_f, parent_fill=fill
            )
            return ((fq, inner_state), acc), None

        ((new_fine, new_inner), acc), _ = jax.lax.scan(
            substep, (fine_state, acc0), None, length=self.factor
        )
        new_coarse = self.restrict(new_coarse, new_fine)
        if do_reflux:
            flux_agg = jax.tree.map(lambda a: a / self.factor, acc)
            new_coarse = self._apply_reflux(new_coarse, coarse_Q, flux_agg, dt)
        return new_coarse, (new_fine, new_inner)

    def run(self, coarse_Q, fine_state, n_steps: int, dt):
        def body(carry, _):
            c, f = carry
            return self.step(c, f, dt), None

        (c, f), _ = jax.lax.scan(body, (coarse_Q, fine_state), None, length=n_steps)
        return c, f


@dataclasses.dataclass
class DynamicRefinement:
    """Criteria-driven re-gridding: adaptive two-level refinement that
    tracks a moving feature.

    The standard AMR-under-XLA recipe, promoted from recipe to API
    (round-1 review item 10): every shape inside a jitted chunk is static,
    so adaptivity happens BETWEEN chunks — integrate a chunk of the coupled
    hierarchy, evaluate ``criterion`` on the host, move the refined region
    to the highest-scoring patch box, rebuild the hierarchy (prolonging the
    new fine level from the running coarse solution), continue.  Compiled
    chunk steps are cached per region box, so re-gridding costs one trace
    the first time each box appears.

    Conservation across a re-grid event is exact: ``restrict`` (run every
    coupled step) makes the coarse region the mean of the fine solution,
    and the piecewise-constant ``prolong_initial`` of the NEW region
    preserves those means — tested to ~1e-13 together with Berger–Colella
    refluxing during the chunks.
    """

    solver: GridSolver
    #: Per-patch score ``criterion(grid, coarse_Q) -> [*grid_shape]``
    #: (host-side NumPy, :mod:`exahype_jax.parallel.criteria`); defaults to
    #: :func:`~exahype_jax.parallel.criteria.gradient_indicator`.
    criterion: Optional[callable] = None
    #: Patch-box half width around the highest-scoring patch.
    half_width: int = 1
    factor: int = 3
    reflux: bool = True

    def __post_init__(self):
        if self.criterion is None:
            from exahype_jax.parallel.criteria import gradient_indicator

            self.criterion = gradient_indicator
        self._nested_cache: dict[tuple, NestedRefinement] = {}
        self._chunk_cache: dict[tuple, callable] = {}

    # ------------------------------------------------------------- selection

    def pick_region(self, coarse_Q) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """Half-open coarse-patch box around the highest-scoring patch."""
        from exahype_jax.parallel.criteria import region_around_max

        grid = self.solver.grid
        scores = np.asarray(self.criterion(grid, coarse_Q))
        return region_around_max(scores, grid.grid_shape, self.half_width)

    # ------------------------------------------------------------ hierarchy

    def nested_for(self, region) -> NestedRefinement:
        if region not in self._nested_cache:
            lo, hi = region
            self._nested_cache[region] = NestedRefinement(
                self.solver,
                region_lo=lo,
                region_hi=hi,
                factor=self.factor,
                reflux=self.reflux,
            )
        return self._nested_cache[region]

    def _chunk_fn(self, region, chunk_steps: int):
        key = (region, chunk_steps)
        if key not in self._chunk_cache:
            nested = self.nested_for(region)
            self._chunk_cache[key] = jax.jit(
                lambda cq, fq, dt: nested.run(cq, fq, chunk_steps, dt)
            )
        return self._chunk_cache[key]

    # ------------------------------------------------------------------ run

    def run(self, coarse_Q, n_chunks: int, chunk_steps: int, dt):
        """Integrate ``n_chunks`` × ``chunk_steps``, re-gridding between
        chunks whenever the criterion moves the region.  Returns
        ``(coarse_Q, fine_Q, info)`` with ``info["regions"]`` the per-chunk
        region boxes and ``info["nested"]`` the final hierarchy."""
        regions = []
        fine_Q = None
        current = None
        for _ in range(n_chunks):
            region = self.pick_region(coarse_Q)
            if region != current:
                # Re-grid: the coarse level already holds the restricted
                # fine solution; prolong the new region from it.
                current = region
                fine_Q = self.nested_for(region).prolong_initial(coarse_Q)
            regions.append(region)
            coarse_Q, fine_Q = self._chunk_fn(region, chunk_steps)(
                coarse_Q, fine_Q, dt
            )
        return (
            coarse_Q,
            fine_Q,
            {"regions": regions, "nested": self.nested_for(current)},
        )


def _set_row(arr, row, idx, axis):
    sl = [slice(None)] * arr.ndim
    sl[axis] = idx
    return arr.at[tuple(sl)].set(row)


def _assemble_jnp(grid, Q):
    """assemble_global, staying in jnp (traceable)."""
    cfg = grid.config
    h, P = cfg.halo_size, cfg.patch_size
    interior = Q
    for d in range(cfg.dim):
        ax = cfg.dim + d
        sl = [slice(None)] * interior.ndim
        sl[ax] = slice(h, h + P)
        interior = interior[tuple(sl)]
    order = []
    for d in range(cfg.dim):
        order += [d, cfg.dim + d]
    order.append(2 * cfg.dim)
    interleaved = jnp.transpose(interior, order)
    shape = tuple(g * P for g in grid.grid_shape) + (cfg.n_vars,)
    return interleaved.reshape(shape)
