"""Tree-structured (non-box) refinement: a static-capacity fine-patch pool.

:class:`~exahype_jax.parallel.refine.NestedRefinement` refines one
axis-aligned BOX of coarse patches; real adaptive grids (the Peano trees the
reference delegates to, SURVEY.md §0/§2) refine arbitrary scattered sets.
This module supplies that capability in a static-shape form:

- refinement is a per-coarse-patch boolean mask — any set, no box constraint;
- every refined coarse patch is covered by ``factor**dim`` fine patches of
  the SAME kernel shape at spacing ``dx/factor``, stored in a **pool** array
  ``[capacity, *extent, n_vars]`` with static capacity;
- the refinement pattern lives in :class:`PoolTables` — slot coordinates,
  activity mask, and a per-face fine-neighbour index table — which are
  ordinary *array arguments* of the jitted step.  Re-gridding changes table
  VALUES, never shapes, so ONE compiled executable serves every refinement
  pattern up to the capacity (the box path re-traces per region;
  ``tests/test_pool.py`` asserts zero recompiles across re-grids).

Coupling per coarse step (mirrors ``refine.NestedRefinement``):

1. coarse solver step everywhere (refined cells overwritten by restriction);
2. ``factor`` fine sub-steps at ``dt/factor``; before each, every pool
   slot's halos fill axis-by-axis — from the fine neighbour's interior edge
   slab where one exists (gather by the neighbour table), else by
   piecewise-constant prolongation of the coarse solution;
3. conservative restriction (fine cell means scatter onto the coarse cells
   they cover) and Berger–Colella refluxing on every coarse–fine face
   (``neighbor == -1``), so the composite mass is conserved to rounding for
   arbitrary refinement sets.

Fine–fine faces are conservative by construction (both sides evaluate the
same symmetric Rusanov flux from identical left/right states).  Interface
coupling is first order in time (coarse boundary data frozen within a
coarse step), as in the box path.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.parallel.grid import PatchGrid
from exahype_jax.parallel.refine import (
    _assemble_jnp,
    advance_with_fill,
    reflux_physics,
    rusanov_face,
)
from exahype_jax.parallel.solver import GridSolver
from exahype_jax.utils.errors import SemanticError
from exahype_jax.utils.output import disassemble_global


class PoolTables(NamedTuple):
    """The refinement pattern as data (a pytree of same-shape arrays).

    - ``coords``: int32 ``[capacity, dim]`` — slot position in the GLOBAL
      fine-patch index space (coarse patch ``c``, sub-offset ``o`` →
      ``c*factor + o``); zeros for inactive slots.
    - ``active``: bool ``[capacity]``.
    - ``neighbor``: int32 ``[capacity, dim, 2]`` — pool index of the
      (lo, hi) fine neighbour along each axis, or ``-1`` where the
      neighbouring cells are unrefined (a coarse–fine face).
    - ``wall``: bool ``[capacity, dim, 2]`` — the face lies on a
      reflective domain wall (all-False on periodic domains).
    """

    coords: jnp.ndarray
    active: jnp.ndarray
    neighbor: jnp.ndarray
    wall: jnp.ndarray

    @property
    def n_active(self) -> int:
        return int(np.sum(np.asarray(self.active)))


@dataclasses.dataclass
class PatchPoolRefinement:
    """Two-level solver over an ARBITRARY set of refined coarse patches.

    ``capacity`` bounds the number of simultaneously refined COARSE patches
    (the pool holds ``capacity * factor**dim`` fine patches).  The coarse
    solver must be a periodic AoS :class:`GridSolver` (``backend="jax"``)
    whose ``patch_size`` is divisible by ``factor``.
    """

    coarse: GridSolver
    capacity: int
    factor: int = 3
    #: Berger–Colella refluxing on coarse–fine faces (flux-form specs with
    #: Flux/maxEigenvalue callbacks and ``kernel_dt="lambda"`` only;
    #: auto-disabled otherwise, like ``refine.NestedRefinement``).
    reflux: bool = True
    #: Keyword arguments forwarded to the fine pool's ``JAXPrinter``.
    fine_backend_kwargs: Optional[dict] = None

    def __post_init__(self):
        grid = self.coarse.grid
        cfg = grid.config
        if not isinstance(grid, PatchGrid):
            raise SemanticError("PatchPoolRefinement drives AoS PatchGrid solvers")
        # Periodic domains and reflective walls are both supported; the
        # wall mirror uses the grid's ``reflect_fn`` hook (symmetry
        # boundary without it), exactly like ``PatchGrid.halo_fill``.
        if cfg.patch_size % self.factor != 0:
            raise SemanticError(
                f"patch_size ({cfg.patch_size}) must be divisible by "
                f"factor ({self.factor}) for conservative restriction"
            )
        if cfg.halo_size > cfg.patch_size:
            raise SemanticError("halo_size must not exceed patch_size")
        if self.capacity < 1:
            raise SemanticError("capacity must be >= 1")
        self.pool_size = self.capacity * self.factor**cfg.dim
        self.fine_dx = self.coarse.dx / self.factor
        #: Fine patches per axis of the global fine-patch index space.
        self.fine_patch_shape = tuple(g * self.factor for g in grid.grid_shape)
        # The pool's own kernel lowering: same spec, pool-sized patch batch.
        pool_kernel = self.coarse.kernel.with_n_patches(self.pool_size)
        kw = dict(self.fine_backend_kwargs or {})
        from exahype_jax.backends.jax_backend import JAXPrinter

        self._fine_kernel_fn = JAXPrinter(pool_kernel, **kw).build()

    # ---------------------------------------------------------- sharding

    def pool_sharding(self, mesh, axis_name: str = None):
        """NamedSharding that partitions the fine pool's SLOT axis over the
        mesh — the multi-chip form of the pool (each device steps only its
        own slots; round-2 VERDICT item 2).

        Slot→device assignment: :meth:`build_tables` numbers slots in
        refined-coarse-patch order with one patch's ``factor**dim`` fine
        patches contiguous, so a slot block maps whole refined patches to a
        device and intra-patch fine–fine ghost gathers stay shard-local;
        only cross-patch edges cross shards (GSPMD materialises those from
        the gathered h-wide edge slab).  Re-gridding keeps the property:
        :meth:`regrid`'s carry gather and prolongation run under the same
        sharding, so re-partitioning is the ordinary GSPMD resharding of
        the new table's slot order.
        """
        from jax.sharding import NamedSharding, PartitionSpec

        from exahype_jax.parallel.mesh import PATCH_AXIS

        axis_name = axis_name or PATCH_AXIS
        n_dev = mesh.shape[axis_name]
        if self.pool_size % n_dev != 0:
            raise SemanticError(
                f"pool size {self.pool_size} must divide the mesh "
                f"({n_dev} devices) — pick capacity a multiple of "
                f"{n_dev} / factor**dim"
            )
        ndim = 1 + self.coarse.grid.config.dim + 1  # [slots, extent.., vars]
        return NamedSharding(
            mesh, PartitionSpec(axis_name, *([None] * (ndim - 1)))
        )

    # ------------------------------------------------------------ tables

    def build_tables(self, refined_mask: np.ndarray) -> PoolTables:
        """Host-side: tables for a per-coarse-patch boolean mask."""
        grid = self.coarse.grid
        mask = np.asarray(refined_mask, dtype=bool)
        if mask.shape != tuple(grid.grid_shape):
            raise SemanticError(
                f"refined_mask shape {mask.shape} != grid {grid.grid_shape}"
            )
        refined = [tuple(c) for c in np.argwhere(mask)]
        if len(refined) > self.capacity:
            raise SemanticError(
                f"{len(refined)} refined patches exceed capacity {self.capacity}"
            )
        dim, r = grid.config.dim, self.factor
        M = self.pool_size
        coords = np.zeros((M, dim), np.int32)
        active = np.zeros((M,), bool)
        slot_of: dict[tuple[int, ...], int] = {}
        m = 0
        for c in refined:
            for o in itertools.product(range(r), repeat=dim):
                coords[m] = [c[d] * r + o[d] for d in range(dim)]
                active[m] = True
                slot_of[tuple(coords[m])] = m
                m += 1
        neighbor = np.full((M, dim, 2), -1, np.int32)
        wall = np.zeros((M, dim, 2), bool)
        reflective = grid.boundary == "reflective"
        for s in range(m):
            for d in range(dim):
                for side, shift in ((0, -1), (1, +1)):
                    nb = list(coords[s])
                    nb[d] += shift
                    if reflective and not (
                        0 <= nb[d] < self.fine_patch_shape[d]
                    ):
                        wall[s, d, side] = True
                        continue
                    nb[d] %= self.fine_patch_shape[d]
                    neighbor[s, d, side] = slot_of.get(tuple(nb), -1)
        return PoolTables(
            coords=jnp.asarray(coords),
            active=jnp.asarray(active),
            neighbor=jnp.asarray(neighbor),
            wall=jnp.asarray(wall),
        )

    # ---------------------------------------------------------- gathers

    def _block_gather_indices(self, coords):
        """Per-axis coarse-CELL indices of every slot's halo-extended block:
        a list of ``[capacity*r^dim, extent]`` int arrays (periodic wrap)."""
        cfg = self.coarse.grid.config
        P, h, r = cfg.patch_size, cfg.halo_size, self.factor
        out = []
        for d in range(cfg.dim):
            n_cells = self.coarse.grid.grid_shape[d] * P
            pos = coords[:, d, None] * P + jnp.arange(cfg.extent)[None, :] - h
            out.append(jnp.mod(jnp.floor_divide(pos, r), n_cells))
        return out

    @staticmethod
    def _gather(CG, ix_axes):
        """``[M, L0, ..., V]`` blocks from a global cell array ``CG``."""
        dim = len(ix_axes)
        M = ix_axes[0].shape[0]
        idx = []
        for d, ix in enumerate(ix_axes):
            shape = [M] + [1] * dim
            shape[1 + d] = ix.shape[1]
            idx.append(ix.reshape(shape))
        return CG[tuple(idx)]

    def _prolong_blocks(self, coarse_global, coords):
        """Piecewise-constant prolongation: every slot's full halo-extended
        fine block gathered from the containing coarse cells."""
        return self._gather(coarse_global, self._block_gather_indices(coords))

    # ------------------------------------------------------------- state

    def init_pool(self, coarse_Q, tables: PoolTables):
        """Fine pool prolonged from the coarse solution.

        Inactive slots also hold prolonged data (coords 0): they never
        contribute (the neighbour table only targets active slots and the
        scatters drop them), but stepping them stays well-posed for
        physics with positivity requirements (no 1/0 from zero density)."""
        cg = _assemble_jnp(self.coarse.grid, coarse_Q)
        return self._prolong_blocks(cg, tables.coords)

    # --------------------------------------------------------- halo fill

    def halo_index_map(self, tables: PoolTables):
        """The axis-by-axis halo fill composed into one source map (same
        optimization as ``aderdg_pool.ghost_index_map``: every fill step is
        a pure copy, so the sequential recurrence runs once per coarse step
        on an int32 index grid and each substep's fill becomes a single
        gather).  Returns ``(idx, use_up)`` flat over the ``[M, extent..]``
        positions (variables follow their position)."""
        cfg = self.coarse.grid.config
        P, h = cfg.patch_size, cfg.halo_size
        shape = (self.pool_size,) + (cfg.extent,) * cfg.dim
        F = int(np.prod(shape))
        pos = jnp.arange(F, dtype=jnp.int32).reshape(shape)
        idx = pos
        use_up = jnp.zeros(shape, bool)
        nd = len(shape)
        for d in range(cfg.dim):
            ax = 1 + d

            def sl(lo, hi, _ax=ax):
                s = [slice(None)] * nd
                s[_ax] = slice(lo, hi)
                return tuple(s)

            for side, (halo_rng, src_rng) in enumerate(
                (((0, h), (P, P + h)), ((P + h, P + 2 * h), (h, 2 * h)))
            ):
                nb = tables.neighbor[:, d, side]
                mask = (nb >= 0).reshape((-1,) + (1,) * (nd - 1))
                nb_c = jnp.maximum(nb, 0)
                idx_f = idx[sl(*src_rng)][nb_c]
                up_f = use_up[sl(*src_rng)][nb_c]
                idx = idx.at[sl(*halo_rng)].set(
                    jnp.where(mask, idx_f, pos[sl(*halo_rng)])
                )
                use_up = use_up.at[sl(*halo_rng)].set(
                    jnp.where(mask, up_f, True)
                )
        return idx.reshape(-1), use_up.reshape(-1)

    def halo_fill(self, fine_Q, up_blocks, tables: PoolTables, maps=None):
        """Halo fill via the composed index map: one gather over
        [pool ‖ prolongation], bitwise-identical to the sequential
        axis-by-axis fill (:meth:`halo_fill_sequential`, differential-
        tested), corners included.  The wall-mirror pass (a value
        transform) stays explicit."""
        cfg = self.coarse.grid.config
        if cfg.halo_size == 0:
            return fine_Q
        if maps is None:
            maps = self.halo_index_map(tables)
        idx, use_up = maps
        F = idx.shape[0]
        nv = fine_Q.shape[-1]
        src = jnp.concatenate(
            [fine_Q.reshape(F, nv), up_blocks.reshape(F, nv)], axis=0
        )
        flat_idx = idx + use_up.astype(jnp.int32) * F
        cur = jnp.take(src, flat_idx, axis=0).reshape(fine_Q.shape)
        if self.coarse.grid.boundary == "reflective":
            cur = self._wall_mirror_pass(cur, tables)
        return cur

    def halo_fill_sequential(self, fine_Q, up_blocks, tables: PoolTables):
        """Reference implementation: axis-by-axis halo fill of every pool
        slot — fine-neighbour interior edge slabs where a neighbour exists,
        coarse prolongation otherwise.  Later axes re-export earlier axes'
        halos, so corner ghosts propagate exactly as in
        ``PatchGrid.halo_fill``."""
        cfg = self.coarse.grid.config
        P, h = cfg.patch_size, cfg.halo_size
        if h == 0:
            return fine_Q
        nd = fine_Q.ndim  # [M, extent.., V]
        cur = fine_Q
        for d in range(cfg.dim):
            ax = 1 + d

            def sl(lo, hi, _ax=ax):
                s = [slice(None)] * nd
                s[_ax] = slice(lo, hi)
                return tuple(s)

            for side, (halo_rng, src_rng) in enumerate(
                (((0, h), (P, P + h)), ((P + h, P + 2 * h), (h, 2 * h)))
            ):
                nb = tables.neighbor[:, d, side]
                # Slab-first: slice the h-wide edge slabs, THEN gather by the
                # neighbour table (traffic h/extent of the pool per exchange).
                from_fine = cur[sl(*src_rng)][nb]
                from_coarse = up_blocks[sl(*halo_rng)]
                mask = (nb >= 0).reshape((-1,) + (1,) * (nd - 1))
                cur = cur.at[sl(*halo_rng)].set(
                    jnp.where(mask, from_fine, from_coarse)
                )
        if self.coarse.grid.boundary == "reflective":
            cur = self._wall_mirror_pass(cur, tables)
        return cur

    def _wall_mirror_pass(self, cur, tables: PoolTables):
        # Wall mirror pass AFTER all fine/coarse fills, ascending axes: each
        # mirror's source slab spans the full transverse extent, so corners
        # compose exactly as in PatchGrid.halo_fill (later axes re-export
        # earlier mirrors).
        cfg = self.coarse.grid.config
        P, h = cfg.patch_size, cfg.halo_size
        nd = cur.ndim
        grid = self.coarse.grid
        for d in range(cfg.dim):
            ax = 1 + d

            def msl(lo, hi, _ax=ax):
                s = [slice(None)] * nd
                s[_ax] = slice(lo, hi)
                return tuple(s)

            for side, (halo_rng, src_rng) in enumerate(
                (((0, h), (h, 2 * h)), ((P + h, P + 2 * h), (P, P + h)))
            ):
                mirror = jnp.flip(cur[msl(*src_rng)], axis=ax)
                if grid.reflect_fn is not None:
                    mirror = grid.reflect_fn(mirror, d, nd - 1)
                w = tables.wall[:, d, side].reshape(
                    (-1,) + (1,) * (nd - 1)
                )
                cur = cur.at[msl(*halo_rng)].set(
                    jnp.where(w, mirror, cur[msl(*halo_rng)])
                )
        return cur

    # -------------------------------------------------------- restriction

    def _coarse_cell_footprint(self, tables: PoolTables):
        """Per-axis coarse-cell indices covered by each slot's interior:
        ``[M, P//r]`` arrays (OOB sentinel for inactive slots → dropped)."""
        cfg = self.coarse.grid.config
        w = cfg.patch_size // self.factor
        out = []
        for d in range(cfg.dim):
            n_cells = self.coarse.grid.grid_shape[d] * cfg.patch_size
            base = tables.coords[:, d] * w
            ix = base[:, None] + jnp.arange(w)[None, :]
            ix = jnp.where(tables.active[:, None], ix, n_cells)  # OOB → drop
            out.append(ix)
        return out

    def restrict(self, coarse_Q, fine_Q, tables: PoolTables):
        """Scatter fine cell means onto the coarse cells they cover."""
        cfg = self.coarse.grid.config
        dim, h, P, r = cfg.dim, cfg.halo_size, cfg.patch_size, self.factor
        interior = fine_Q
        for d in range(dim):
            sl = [slice(None)] * fine_Q.ndim
            sl[1 + d] = slice(h, h + P)
            interior = interior[tuple(sl)]
        pooled = interior
        for d in range(dim):
            ax = 1 + d
            shape = pooled.shape
            pooled = pooled.reshape(
                shape[:ax] + (shape[ax] // r, r) + shape[ax + 1 :]
            ).mean(axis=ax + 1)
        cg = _assemble_jnp(self.coarse.grid, coarse_Q)
        ix_axes = self._coarse_cell_footprint(tables)
        idx = []
        M = ix_axes[0].shape[0]
        for d, ix in enumerate(ix_axes):
            shape = [M] + [1] * dim
            shape[1 + d] = ix.shape[1]
            idx.append(ix.reshape(shape))
        cg = cg.at[tuple(idx)].set(pooled, mode="drop")
        return disassemble_global(self.coarse.grid, coarse_Q, cg)

    # ---------------------------------------------------------- refluxing

    def _physics(self):
        return reflux_physics(self.coarse.kernel)

    def _rusanov_face(self, u_left, u_right, d):
        return rusanov_face(self.coarse.kernel, u_left, u_right, d)

    def _pool_transverse(self, rows):
        """Mean-pool every transverse spatial axis by ``factor``
        (rows: ``[M, ..., V]`` with dim-1 transverse axes; the face axis
        was already removed by the row slice)."""
        r = self.factor
        out = rows
        for ax in range(1, out.ndim - 1):
            shape = out.shape
            out = out.reshape(
                shape[:ax] + (shape[ax] // r, r) + shape[ax + 1 :]
            ).mean(axis=ax + 1)
        return out

    def _fine_face_fluxes(self, filled, d):
        """(lo, hi) face fluxes of every slot along axis ``d`` from the
        halo-filled pool state, transverse-pooled to coarse faces."""
        cfg = self.coarse.grid.config
        P, h = cfg.patch_size, cfg.halo_size
        nd = filled.ndim

        def row(spat_idx):
            s = [slice(None)] * nd
            s[1 + d] = spat_idx
            for dd in range(cfg.dim):
                if dd != d:
                    s[1 + dd] = slice(h, h + P)
            return filled[tuple(s)]

        # One batched Riemann evaluation per axis: the lo and hi faces
        # concatenate on the slot axis (identical elementwise math, half
        # the op count — the entry-size cost here is XLA thunk count,
        # not bytes).
        M = filled.shape[0]
        left = jnp.concatenate([row(h - 1), row(h + P - 1)], axis=0)
        right = jnp.concatenate([row(h), row(h + P)], axis=0)
        F = self._pool_transverse(self._rusanov_face(left, right, d))
        return F[:M], F[M:]

    def _face_flux_sample(self, filled):
        """All per-axis (lo, hi) pooled face fluxes of one substep."""
        return [
            self._fine_face_fluxes(filled, d)
            for d in range(self.coarse.grid.config.dim)
        ]

    def _coarse_face_rows_both(self, cg_pre, tables, d, trans2):
        """Both sides' (Riemann-left, Riemann-right, outside-cell) rows in
        ONE footprint gather, concatenated on the slot axis (lo ‖ hi).

        Row roles per side: side 0 (lo face) has the outside cell on the
        Riemann LEFT (``base-1`` vs ``base``); side 1 (hi face) has it on
        the RIGHT (``base+w-1`` vs ``base+w``) — concatenating in Riemann
        order makes one :func:`rusanov_face` call serve both sides.
        ``trans2`` is the doubled (lo ‖ hi) transverse footprint the
        caller already built — footprint entries use the OOB sentinel for
        inactive slots; wrap for the gather (the scatter still drops
        them)."""
        cfg = self.coarse.grid.config
        w = cfg.patch_size // self.factor
        n_d = cg_pre.shape[d]
        base = tables.coords[:, d] * w
        left_i = jnp.concatenate([base - 1, base + w - 1])
        right_i = jnp.concatenate([base, base + w])
        out_i = jnp.concatenate([base - 1, base + w])

        def rows(cell_idx):
            ix_axes = []
            for dd in range(cfg.dim):
                if dd == d:
                    ix_axes.append(jnp.mod(cell_idx, n_d)[:, None])
                else:
                    ix_axes.append(jnp.mod(trans2[dd], cg_pre.shape[dd]))
            g = self._gather(cg_pre, ix_axes)
            return jnp.squeeze(g, axis=1 + d)

        return rows(left_i), rows(right_i), out_i

    def _apply_reflux(self, new_coarse, cg_pre, flux_acc, tables, dt):
        """Correct the coarse cells just outside every coarse–fine face:
        their face flux becomes the substep-averaged fine aggregate."""
        cfg = self.coarse.grid.config
        n_real = cfg.n_real
        lam = dt / self.coarse.dx
        cg = _assemble_jnp(self.coarse.grid, new_coarse)
        M = tables.active.shape[0]
        sign = jnp.concatenate(
            [jnp.full((M,), -1.0, cg.dtype), jnp.full((M,), 1.0, cg.dtype)]
        )
        trans = self._coarse_cell_footprint(tables)
        trans2 = [jnp.concatenate([t, t], axis=0) for t in trans]
        for d in range(cfg.dim):
            n_d = cg.shape[d]
            # Both sides batched on the slot axis (lo ‖ hi): one footprint
            # gather, one Riemann evaluation, one scatter-add per axis —
            # the entry-size cost of the reflux is op count, not bytes.
            left_row, right_row, out_i = self._coarse_face_rows_both(
                cg_pre, tables, d, trans2
            )
            Fc = self._rusanov_face(left_row, right_row, d)
            Ff = jnp.concatenate([flux_acc[d][0], flux_acc[d][1]], axis=0)
            delta = sign.reshape((2 * M,) + (1,) * (Ff.ndim - 1)) * lam * (
                Ff - Fc
            )
            delta_full = jnp.zeros(delta.shape[:-1] + (cfg.n_vars,), delta.dtype)
            delta_full = delta_full.at[..., :n_real].set(delta)
            # The scatter window is 1 cell wide along the face axis.
            delta_full = jnp.expand_dims(delta_full, axis=1 + d)
            # Scatter-add at (out_i, transverse footprint); faces with a
            # fine neighbour (or inactive slots) get an OOB index → drop.
            is_cf = (
                jnp.concatenate([tables.active, tables.active])
                & (
                    jnp.concatenate(
                        [tables.neighbor[:, d, 0], tables.neighbor[:, d, 1]]
                    )
                    < 0
                )
                & ~jnp.concatenate([tables.wall[:, d, 0], tables.wall[:, d, 1]])
            )
            cell = jnp.where(is_cf, jnp.mod(out_i, n_d), n_d)
            ix_axes = []
            for dd in range(cfg.dim):
                ix_axes.append(cell[:, None] if dd == d else trans2[dd])
            idx = []
            for dd, ix in enumerate(ix_axes):
                shape = [2 * M] + [1] * cfg.dim
                shape[1 + dd] = ix.shape[1]
                idx.append(ix.reshape(shape))
            cg = cg.at[tuple(idx)].add(delta_full, mode="drop")
        return disassemble_global(self.coarse.grid, new_coarse, cg)

    # ----------------------------------------------------------------- step

    def _coarse_advance(self, coarse_Q, dt, parent_fill):
        """Coarse step, optionally with a PARENT's halo overwrite — this is
        what lets the pool refine the fine level of a box
        :class:`~exahype_jax.parallel.refine.NestedRefinement` (see
        :class:`PoolInner`)."""
        return advance_with_fill(self.coarse, coarse_Q, dt, parent_fill)

    def step(self, coarse_Q, fine_Q, tables: PoolTables, dt, parent_fill=None):
        """One coupled coarse step; jit once, reuse for every pattern."""
        cfg = self.coarse.grid.config
        r = self.factor
        new_coarse = self._coarse_advance(coarse_Q, dt, parent_fill)
        cg_pre = _assemble_jnp(self.coarse.grid, coarse_Q)
        up_blocks = self._prolong_blocks(cg_pre, tables.coords)
        dt_f = dt / r
        kdt = dt_f / self.fine_dx if self.coarse.kernel_dt == "lambda" else dt_f
        do_reflux = (
            self.reflux
            and self._physics() is not None
            and self.coarse.kernel_dt == "lambda"
        )

        halo_maps = self.halo_index_map(tables)

        def substep(carry, _):
            fq, acc = carry
            filled = self.halo_fill(fq, up_blocks, tables, maps=halo_maps)
            if do_reflux:
                acc = jax.tree.map(
                    lambda a, b: a + b, acc, self._face_flux_sample(filled)
                )
            fq = self._fine_kernel_fn(filled, kdt)
            return (fq, acc), None

        if do_reflux:
            # Explicit zeros from known shapes (no throwaway halo fill).
            w = cfg.patch_size // r
            zero = jnp.zeros(
                (self.pool_size,) + (w,) * (cfg.dim - 1) + (cfg.n_real,),
                fine_Q.dtype,
            )
            acc0 = [(zero, zero) for _ in range(cfg.dim)]
        else:
            acc0 = 0.0
        (new_fine, acc), _ = jax.lax.scan(substep, (fine_Q, acc0), None, length=r)
        new_coarse = self.restrict(new_coarse, new_fine, tables)
        if do_reflux:
            flux_agg = jax.tree.map(lambda a: a / r, acc)
            new_coarse = self._apply_reflux(
                new_coarse, cg_pre, flux_agg, tables, dt
            )
        return new_coarse, new_fine

    def run(self, coarse_Q, fine_Q, tables: PoolTables, n_steps: int, dt):
        def body(carry, _):
            c, f = carry
            return self.step(c, f, tables, dt), None

        (c, f), _ = jax.lax.scan(
            body, (coarse_Q, fine_Q), None, length=n_steps
        )
        return c, f

    # ---------------------------------------------------------------- regrid

    def regrid(self, coarse_Q, fine_Q, old: PoolTables, new: PoolTables):
        """Fine pool for a NEW pattern: slots whose fine patch already
        existed keep their data (host-side coord matching → device gather);
        newly refined slots prolong from the coarse solution.  Conservation
        across the event is exact (restriction ran every step; prolongation
        preserves coarse means)."""
        old_coords = np.asarray(old.coords)
        old_active = np.asarray(old.active)
        slot_of = {
            tuple(old_coords[m]): m
            for m in range(len(old_active))
            if old_active[m]
        }
        new_coords = np.asarray(new.coords)
        new_active = np.asarray(new.active)
        match = np.array(
            [
                slot_of.get(tuple(new_coords[m]), -1) if new_active[m] else -1
                for m in range(len(new_active))
            ],
            np.int32,
        )
        prolonged = self.init_pool(coarse_Q, new)
        keep = jnp.asarray(match >= 0).reshape(
            (-1,) + (1,) * (fine_Q.ndim - 1)
        )
        return jnp.where(keep, fine_Q[jnp.asarray(match)], prolonged)


class DynamicRunBase:
    """Shared criteria-driven re-gridding loop for the tree pools (FV and
    ADER-DG): score → top-scorer mask (capped at capacity by stable rank)
    → table rebuild → pool carry/prolong → one PATTERN-INDEPENDENT compiled
    chunk.  Subclasses set ``self.pool``, ``self.criterion``,
    ``self._criterion_subject``, and ``self._chunk = {}``."""

    def _mask_from_scores(self, scores: np.ndarray) -> np.ndarray:
        mask = scores >= self.rel_threshold * scores.max()
        if int(mask.sum()) > self.capacity:
            top = np.argsort(scores, axis=None, kind="stable")[::-1]
            mask = np.zeros(scores.size, bool)
            mask[top[: self.capacity]] = True
            mask = mask.reshape(scores.shape)
        return mask

    def pick_mask(self, state):
        return self._mask_from_scores(
            np.asarray(self._score_fn()(state))
        )

    def _score_fn(self):
        """Criterion as an on-device dispatch when the criterion traces
        (the overlap mode's cheap input-state score); host-numpy criteria
        (e.g. :func:`~exahype_jax.parallel.criteria.gradient_indicator`)
        fall back to a plain call — overlap then pays one input-state
        fetch, and the table build still runs under the device chunk."""
        fn = getattr(self, "_scores_fn", None)
        if fn is None:
            def base(s):
                return self.criterion(self._criterion_subject, s)

            jitted = jax.jit(base)
            mode = {"jit": True}

            def fn(s):
                if mode["jit"]:
                    try:
                        return jitted(s)
                    except jax.errors.TracerArrayConversionError:
                        mode["jit"] = False
                return base(s)

            self._scores_fn = fn
        return fn

    def _chunk_fn(self, chunk_steps: int):
        if chunk_steps not in self._chunk:
            self._chunk[chunk_steps] = jax.jit(
                lambda cq, fq, tables, dt: self.pool.run(
                    cq, fq, tables, chunk_steps, dt
                )
            )
        return self._chunk[chunk_steps]

    def run(self, Q0, n_chunks: int, chunk_steps: int, dt,
            overlap_regrid: bool = False):
        """Returns ``(coarse, fine, info)`` with ``info["masks"]`` the
        per-chunk refinement sets and ``info["tables"]`` the final tables.

        ``overlap_regrid=True`` takes the HOST out of the re-grid loop's
        critical path: the refinement pattern for chunk ``k+1`` is scored
        from chunk ``k``'s INPUT state (a tiny on-device reduction whose
        fetch does not wait on the running chunk), so the host-side table
        construction executes UNDER chunk ``k``'s device dispatch instead
        of between chunks.  The pattern therefore LAGS one chunk
        (``chunk_steps`` steps) behind the front — the classic
        regrid-with-margin trade: keep ``rel_threshold`` low enough (or
        chunks short enough) that the criterion's buffer zone covers one
        chunk of front motion.  Chunk 0 is scored from ``Q0`` directly
        (nothing to overlap yet), so both modes start from the same
        pattern."""
        masks = []
        tables = None
        fine = None
        coarse = Q0
        fn = self._chunk_fn(chunk_steps)
        if not overlap_regrid:
            for _ in range(n_chunks):
                mask = self.pick_mask(coarse)
                new_tables = self.pool.build_tables(mask)
                if tables is None:
                    fine = self.pool.init_pool(coarse, new_tables)
                else:
                    fine = self.pool.regrid(coarse, fine, tables, new_tables)
                tables = new_tables
                masks.append(mask)
                coarse, fine = fn(coarse, fine, tables, dt)
            return coarse, fine, {"masks": masks, "tables": tables}

        score = self._score_fn()
        mask = self.pick_mask(coarse)
        tables = self.pool.build_tables(mask)
        fine = self.pool.init_pool(coarse, tables)
        masks.append(mask)
        for k in range(n_chunks):
            scores_dev = score(coarse) if k + 1 < n_chunks else None
            coarse, fine = fn(coarse, fine, tables, dt)  # async dispatch
            if scores_dev is None:
                break
            # Host work below overlaps the chunk running on device: the
            # scores were computed from the chunk's INPUT, so fetching
            # them does not wait for the chunk itself.
            mask = self._mask_from_scores(np.asarray(scores_dev))
            new_tables = self.pool.build_tables(mask)
            masks.append(mask)
            fine = self.pool.regrid(coarse, fine, tables, new_tables)
            tables = new_tables
        return coarse, fine, {"masks": masks, "tables": tables}


@dataclasses.dataclass
class PoolInner:
    """Adapter: a :class:`PatchPoolRefinement` as the ``inner`` level of a
    box :class:`~exahype_jax.parallel.refine.NestedRefinement` — MIXED
    box/tree hierarchies (coarse grid → rectangular fine region → arbitrary
    scattered sub-patches), closing the multi-level-pool roadmap item.

    Build the pool over ``nested.fine`` (a proper :class:`GridSolver`),
    then ``nested.inner = PoolInner(pool, tables)``.  Proper nesting:
    keep the pool's refined patches OFF the box region's boundary ring, so
    the box-level refluxing (which samples the fine level's boundary
    fluxes) stays exact — composite conservation to rounding (tested).
    """

    pool: PatchPoolRefinement
    tables: PoolTables

    def __post_init__(self):
        # Proper nesting is a CORRECTNESS precondition, not a preference:
        # a refined patch on the box's boundary ring would exchange data
        # across the region's fictitious periodic wrap.  Fail loudly.
        r = self.pool.factor
        coords = np.asarray(self.tables.coords)
        active = np.asarray(self.tables.active)
        grid = self.pool.coarse.grid.grid_shape
        for m in np.flatnonzero(active):
            cp = coords[m] // r
            if any(cp[d] == 0 or cp[d] == grid[d] - 1 for d in range(len(grid))):
                raise SemanticError(
                    f"PoolInner patch {tuple(cp)} touches the box region's "
                    "boundary ring; proper nesting requires refined patches "
                    "strictly inside the region"
                )

    def init_state(self, fine_Q):
        return self.pool.init_pool(fine_Q, self.tables)

    def step(self, fq, state, dt, parent_fill=None):
        return self.pool.step(
            fq, state, self.tables, dt, parent_fill=parent_fill
        )


@dataclasses.dataclass
class DynamicPoolRefinement(DynamicRunBase):
    """Criteria-driven tree re-gridding with ONE compiled chunk function.

    Each chunk: score the coarse patches (host), refine the top scorers (any
    scattered set, capped at ``capacity``), rebuild tables, carry/prolong
    the pool, run ``chunk_steps`` coupled steps.  Because the pattern is
    array data, every chunk reuses the same jitted executable — re-gridding
    costs a table rebuild, not a retrace (contrast
    ``refine.DynamicRefinement``'s per-box cache)."""

    solver: GridSolver
    capacity: int
    #: Per-patch score fn ``criterion(grid, coarse_Q) -> [*grid_shape]``;
    #: defaults to :func:`~exahype_jax.parallel.criteria.gradient_indicator`.
    criterion: Optional[callable] = None
    #: Refine patches scoring within ``rel_threshold`` of the max (capped
    #: at ``capacity`` by score rank).
    rel_threshold: float = 0.5
    factor: int = 3
    reflux: bool = True

    def __post_init__(self):
        if self.criterion is None:
            from exahype_jax.parallel.criteria import gradient_indicator

            self.criterion = gradient_indicator
        self.pool = PatchPoolRefinement(
            self.solver,
            capacity=self.capacity,
            factor=self.factor,
            reflux=self.reflux,
        )
        self._criterion_subject = self.solver.grid
        self._chunk = {}

    # pick_mask / _chunk_fn / run come from DynamicRunBase.
