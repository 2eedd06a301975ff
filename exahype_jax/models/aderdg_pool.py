"""Tree-structured (non-box) refinement for ADER-DG: a fine-block pool.

:class:`~exahype_jax.models.aderdg_amr.ADERDGNestedRefinement` refines one
axis-aligned cell box.  This module refines an ARBITRARY set of coarse
cells — the Peano-tree capability on the flagship scheme — with the same
static-shape pattern as the FV pool (``parallel/pool.py``):

- every refined coarse cell owns one fine BLOCK of ``(factor+2)**dim``
  cells at spacing ``dx/factor``: its ``factor**dim`` interior cells plus a
  one-cell ghost ring;
- all blocks stack along the LAST grid axis of ONE fine
  :class:`ADERDGSolver` (``grid_shape = (r+2,)*(dim-1) + (capacity*(r+2),)``
  — the block axis is the trailing, contiguous one), and the ordinary
  periodic fine step runs unchanged — the wrap
  couples ghost rows to ghost rows only, and ghosts are re-imposed before
  every sub-step (the box path's extended-grid trick, per cell);
- the refinement pattern (cell coords / activity / per-face neighbour
  table) is ARRAY DATA consumed by one jitted step: re-gridding rebuilds
  tables, never retraces.

Ghost data per sub-step: the polynomial prolongation of the pre-step
coarse solution (exact degree-N interpolation,
:func:`~exahype_jax.models.dg.refine_interpolation`), overwritten by the
neighbour block's interior face row wherever the face neighbour cell is
also refined — so fine–fine faces carry fine data on both sides and are
conservative by symmetry (both blocks evaluate the identical Rusanov flux
from identical states).  Coarse–fine faces get Berger–Colella refluxing:
the outside coarse cell's nodal surface contribution is corrected so its
boundary-face flux becomes the substep-averaged, transversely L2-projected
fine aggregate — the composite mass is conserved to rounding for arbitrary
refinement sets (tested).  Interface coupling is first order in time, as in
the box path.

The ghost redundancy is the price of pattern-independence: each refined
cell carries ``(r+2)^dim / r^dim`` fine cells (≈2.8× at r=3 in 2-D, ≈4.6×
in 3-D).  For clustered sets the box path is cheaper per step but retraces
per region; the pool trades FLOPs for a single executable.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from exahype_jax.models.aderdg import ADERDGSolver
from exahype_jax.models.dg import refine_interpolation, refine_restriction
from exahype_jax.parallel.pool import DynamicRunBase
from exahype_jax.utils.errors import SemanticError

#: Every einsum of state at HIGHEST precision (see models/aderdg.py).
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class CellPoolTables(NamedTuple):
    """Refinement pattern as data: coarse-CELL coords ``[capacity, dim]``,
    ``active [capacity]``, ``neighbor [capacity, dim, 2]`` (pool slot of
    the refined (lo, hi) face-neighbour cell, or ``-1`` when that cell is
    unrefined), and ``wall [capacity, dim, 2]`` (the face lies on a
    reflective domain wall; all-False on periodic domains)."""

    coords: jnp.ndarray
    active: jnp.ndarray
    neighbor: jnp.ndarray
    wall: jnp.ndarray

    @property
    def n_active(self) -> int:
        return int(np.sum(np.asarray(self.active)))


@dataclasses.dataclass
class ADERDGPoolRefinement:
    """Two-level ADER-DG over an arbitrary set of refined coarse cells."""

    coarse: ADERDGSolver
    #: Max number of simultaneously refined coarse cells (static).
    capacity: int
    factor: int = 3
    reflux: bool = True
    #: Optional wrapper for the fine-pool stepper, e.g.
    #: ``lambda s: LimitedADERDG(s)`` — subcell shock capturing on the
    #: refined blocks.  Must expose ``step(u, dt, return_face_fluxes=...)``.
    fine_factory: object = None
    #: Same for the coarse level (the production configuration limits
    #: BOTH levels; the limiter's effective face fluxes keep the reflux
    #: accounting exact on either side).
    coarse_factory: object = None

    def __post_init__(self):
        c = self.coarse
        # Periodic domains and reflective walls are both supported.  Wall
        # faces of refined cells are imposed through MIRROR GHOST CELLS:
        # the interior edge cell's nodal state flipped along the face-normal
        # node axis and passed through ``reflect_fn``.  Because the
        # physics' reflection symmetry commutes with the dynamics (that is
        # precisely what reflect_fn/reflect_flux_fn encode), the mirror
        # ghost's predictor output is the mirror of the interior's, so the
        # periodic fine step reproduces the wall-aware face stage exactly.
        # (The box path, aderdg_amr, remains periodic-only.)
        if self.capacity < 1:
            raise SemanticError("capacity must be >= 1")
        if c.boundary not in ("periodic", "reflective"):
            raise SemanticError(
                f"the ADER-DG pool does not support {c.boundary} "
                "boundaries: its ghost tables implement the periodic and "
                "mirror-wall contracts only"
            )
        if getattr(c, "wall_axes", None) is not None:
            raise SemanticError(
                "the ADER-DG pool does not support per-axis wall_axes: "
                "its wall tables mirror every out-of-domain face"
            )
        r = self.factor
        self.block = r + 2  # fine cells per axis incl. the ghost ring
        B, M = self.block, self.capacity
        # Blocks stack along the LAST grid axis: M*B is the only large
        # extent, and the trailing axis is the contiguous one.
        self.fine = ADERDGSolver(
            dim=c.dim,
            order=c.order,
            n_vars=c.n_vars,
            grid_shape=(B,) * (c.dim - 1) + (M * B,),
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
        # Block position j in [0, B) covers coarse-cell offset (j-1)//r and
        # fine subinterval (j-1) mod r (ghosts j=0 / j=B-1 live in the
        # neighbouring coarse cells).
        self._c_off = (np.arange(B) - 1) // r
        self._k_idx = np.mod(np.arange(B) - 1, r)

    # ------------------------------------------------------------ tables

    def build_tables(self, refined_mask: np.ndarray) -> CellPoolTables:
        """Host-side: tables for a per-coarse-CELL boolean mask."""
        c = self.coarse
        mask = np.asarray(refined_mask, dtype=bool)
        if mask.shape != tuple(c.grid_shape):
            raise SemanticError(
                f"refined_mask shape {mask.shape} != grid {c.grid_shape}"
            )
        refined = [tuple(x) for x in np.argwhere(mask)]
        if len(refined) > self.capacity:
            raise SemanticError(
                f"{len(refined)} refined cells exceed capacity {self.capacity}"
            )
        M, dim = self.capacity, c.dim
        coords = np.zeros((M, dim), np.int32)
        active = np.zeros((M,), bool)
        slot_of = {}
        for m, cell in enumerate(refined):
            coords[m] = cell
            active[m] = True
            slot_of[cell] = m
        neighbor = np.full((M, dim, 2), -1, np.int32)
        wall = np.zeros((M, dim, 2), bool)
        reflective = c.boundary == "reflective"
        for m in range(len(refined)):
            for d in range(dim):
                for side, shift in ((0, -1), (1, +1)):
                    nb = list(coords[m])
                    nb[d] += shift
                    if reflective and not (0 <= nb[d] < c.grid_shape[d]):
                        wall[m, d, side] = True
                        continue
                    nb[d] %= c.grid_shape[d]
                    neighbor[m, d, side] = slot_of.get(tuple(nb), -1)
        return CellPoolTables(
            coords=jnp.asarray(coords),
            active=jnp.asarray(active),
            neighbor=jnp.asarray(neighbor),
            wall=jnp.asarray(wall),
        )

    # ----------------------------------------------------- (un)stacking

    @property
    def _m_axis(self) -> int:
        return self.coarse.dim + 1

    def _block_axis(self, d: int) -> int:
        return self.coarse.dim + 2 + d

    def unstack(self, fs):
        """Stacked fine state → the canonical ``[n^dim, V, M, b0, ...]``
        block view (an un-merge of the trailing axis plus one transpose —
        every indexing helper works on this canonical layout)."""
        B, M = self.block, self.capacity
        shape = fs.shape[:-1] + (M, B)
        return jnp.moveaxis(fs.reshape(shape), -2, self._m_axis)

    def stack(self, x):
        x = jnp.moveaxis(x, self._m_axis, -2)
        shape = x.shape[:-2] + (self.capacity * self.block,)
        return x.reshape(shape)

    # ------------------------------------------------------ prolongation

    def prolong_blocks(self, uc, coords):
        """Polynomial prolongation of the coarse field onto every slot's
        full (ghost-extended) block: ``[n^dim, V, M, B, ...]``."""
        c = self.coarse
        dim, B = c.dim, self.block
        M = coords.shape[0]
        idx = []
        for d in range(dim):
            ci = jnp.mod(
                coords[:, d, None] + jnp.asarray(self._c_off)[None, :],
                c.grid_shape[d],
            )  # [M, B]
            shape = [M] + [1] * dim
            shape[1 + d] = B
            idx.append(ci.reshape(shape))
        x = uc[(Ellipsis,) + tuple(idx)]  # [n^dim, V, M, B, ...]
        T = jnp.asarray(self._P, uc.dtype)[jnp.asarray(self._k_idx)]  # [B,nf,nc]
        for d in range(dim):
            node_ax = c.node_axis(d)
            block_ax = self._block_axis(d)
            x2 = jnp.moveaxis(x, (node_ax, block_ax), (0, 1))  # [n_c, B, ...]
            x2 = _einsum("fij,jf...->if...", T, x2)
            x = jnp.moveaxis(x2, (0, 1), (node_ax, block_ax))
        return x

    def init_pool(self, uc, tables: CellPoolTables):
        """Stacked fine state prolonged from the coarse solution.

        Inactive slots also hold prolonged data (coords 0): isolated from
        the coupling, but well-posed for positivity-constrained physics."""
        return self.stack(self.prolong_blocks(uc, tables.coords))

    def block_nodes_meshgrid(self, tables: CellPoolTables):
        """Physical node coordinates of every block (ghost-extended), one
        broadcastable array per dim over the UNSTACKED pool layout
        ``[n^dim, 1, M, B, ...]`` — evaluate exact data directly at fine
        resolution (cf. ``ADERDGNestedRefinement.fine_coords``)."""
        c = self.coarse
        r, B, M = self.factor, self.block, self.capacity
        nodes = jnp.asarray(np.asarray(c.ops.nodes))
        out = []
        nd = 2 * c.dim + 2  # node axes + V + M + block axes
        for d in range(c.dim):
            fine_cell = tables.coords[:, d][:, None] * r + (
                jnp.arange(B) - 1
            )[None, :]  # [M, B]
            coords = (
                (nodes[:, None, None] + fine_cell[None]) / r * c._dxs[d]
            )  # [n, M, B]
            shape = [1] * nd
            shape[c.node_axis(d)] = c.n_nodes
            shape[self._m_axis] = M
            shape[self._block_axis(d)] = B
            out.append(coords.reshape(shape))
        return out

    def _m_take(self, slab, nb):
        """Gather over the M grouping of the trailing (M*B) axis."""
        B, M = self.block, self.capacity
        v = slab.reshape(slab.shape[:-1] + (M, B))
        return jnp.take(v, nb, axis=-2).reshape(slab.shape)

    def _stacked_slices(self, nd, grid_base, d, gpos, src):
        """(ghost, source) slice tuples for block position ``gpos``/``src``
        along axis ``d`` of a last-axis-stacked array whose first grid axis
        sits at ``grid_base`` (dim+1 for state/prolongation arrays, 0 for
        the flag grid)."""
        if d == self.coarse.dim - 1:  # the stacked axis: strided slices
            B = self.block
            return (
                (Ellipsis, slice(gpos, None, B)),
                (Ellipsis, slice(src, None, B)),
            )
        sax = grid_base + d
        sl_g = [slice(None)] * nd
        sl_g[sax] = slice(gpos, gpos + 1)
        sl_s = [slice(None)] * nd
        sl_s[sax] = slice(src, src + 1)
        return tuple(sl_g), tuple(sl_s)

    # -------------------------------------------------------- ghost fill

    def ghost_index_map(self, tables: CellPoolTables):
        """The axis-by-axis ghost fill COMPOSED into one source map.

        The sequential fill is 4 strided gathers + 4 strided scatters per
        fill, 12 fills per chunk.  Every fill step is a pure copy ("ghost position g takes the
        CURRENT value at source s, or the prolongation at g"), so the whole
        sequential fill composes into a single gather: run the same
        axis-by-axis recurrence on an int32 index grid (cheap: F =
        B^(dim-1)·M·B elements, once per coarse step), yielding per flat
        position the ORIGINAL-array source index and an is-prolongation
        flag.  :meth:`ghost_fill` then applies it as ONE flat gather —
        bitwise-identical to the sequential fill (differential-tested),
        including corner-ghost propagation.
        """
        c = self.coarse
        dim, B, r = c.dim, self.block, self.factor
        grid = self.fine.grid_shape
        F = int(np.prod(grid))
        pos = jnp.arange(F, dtype=jnp.int32).reshape(grid)
        idx = pos
        use_up = jnp.zeros(grid, bool)
        nd = dim
        for d in range(dim):
            stacked = d == dim - 1
            for side, (gpos, src) in enumerate(((0, r), (B - 1, 1))):
                nb = tables.neighbor[:, d, side]
                ok = nb >= 0
                sl_g, sl_s = self._stacked_slices(nd, 0, d, gpos, src)
                if stacked:
                    src_idx = jnp.take(idx[sl_s], nb, axis=-1)
                    src_up = jnp.take(use_up[sl_s], nb, axis=-1)
                    okb = ok
                else:
                    src_idx = self._m_take(idx[sl_s], nb)
                    src_up = self._m_take(use_up[sl_s], nb)
                    okb = jnp.repeat(ok, B)
                idx = idx.at[sl_g].set(jnp.where(okb, src_idx, pos[sl_g]))
                use_up = use_up.at[sl_g].set(jnp.where(okb, src_up, True))
        return idx.reshape(-1), use_up.reshape(-1)

    def ghost_fill(self, fs, up_stacked, tables: CellPoolTables, maps=None):
        """Re-impose every block's ghost ring via the composed index map
        (:meth:`ghost_index_map`): one flat gather over [pool ‖
        prolongation] replaces the 4-gather/4-scatter sequential fill.
        Pass ``maps`` (computed once per coarse step) to amortise the map
        build across the ``factor`` sub-steps.  The wall-mirror pass (a
        value TRANSFORM — node-axis flip + ``reflect_fn`` — not a copy)
        stays explicit, applied after, exactly as in the sequential
        order."""
        if maps is None:
            maps = self.ghost_index_map(tables)
        idx, use_up = maps
        c = self.coarse
        lead = fs.shape[: c.dim + 1]
        F = idx.shape[0]
        src = jnp.concatenate(
            [fs.reshape(lead + (F,)), up_stacked.reshape(lead + (F,))],
            axis=-1,
        )
        flat_idx = idx + use_up.astype(jnp.int32) * F
        x = jnp.take(src, flat_idx, axis=-1).reshape(fs.shape)
        if c.boundary == "reflective":
            x = self._wall_mirror_pass(x, tables)
        return x

    def ghost_fill_sequential(self, fs, up_stacked, tables: CellPoolTables):
        """Reference implementation of the ghost fill (the composed-map
        path in :meth:`ghost_fill` is differential-tested against this).

        Axis-by-axis, so ghost corners between refined neighbours
        propagate (as in the FV pool's halo fill).  Operates entirely in
        the STACKED layout: the (M, B) structure of the trailing axis is
        addressed with free reshapes and strided slices, so no transposes
        (an unstack/stack pair would relayout the full pool on every
        call).  ``up_stacked`` is the stacked prolongation (one
        transpose per COARSE step, in :meth:`step`)."""
        c = self.coarse
        r, B = self.factor, self.block
        dim = c.dim
        x = fs
        nd = x.ndim

        for d in range(dim):
            stacked = d == dim - 1
            for side, (gpos, src) in enumerate(((0, r), (B - 1, 1))):
                nb = tables.neighbor[:, d, side]
                ok = nb >= 0
                sl_g, sl_s = self._stacked_slices(nd, dim + 1, d, gpos, src)
                if stacked:
                    from_fine = jnp.take(x[sl_s], nb, axis=-1)
                    vals = jnp.where(ok, from_fine, up_stacked[sl_g])
                else:
                    from_fine = self._m_take(x[sl_s], nb)
                    vals = jnp.where(
                        jnp.repeat(ok, B), from_fine, up_stacked[sl_g]
                    )
                x = x.at[sl_g].set(vals)
        if c.boundary == "reflective":
            x = self._wall_mirror_pass(x, tables)
        return x

    def _wall_mirror_pass(self, x, tables: CellPoolTables):
        """Wall mirror pass AFTER the fine/coarse fills, ascending axes (the
        mirror source spans the full transverse extent, so corner ghosts
        compose like the FV pool's wall pass).  Own interior edge cell,
        flipped along the face-normal NODE axis, reflect_fn-transformed."""
        c = self.coarse
        dim, B, r = c.dim, self.block, self.factor
        nd = x.ndim
        for d in range(dim):
            stacked = d == dim - 1
            node_ax = c.node_axis(d)
            for side, (gpos, src) in enumerate(((0, 1), (B - 1, r))):
                w = tables.wall[:, d, side]
                sl_g, sl_s = self._stacked_slices(
                    nd, dim + 1, d, gpos, src
                )
                mirror = jnp.flip(x[sl_s], axis=node_ax)
                mirror = c.reflect_fn(mirror, d, c.var_axis)
                wmask = w if stacked else jnp.repeat(w, B)
                x = x.at[sl_g].set(jnp.where(wmask, mirror, x[sl_g]))
        return x

    def _sync_troubled(self, troubled, tables: CellPoolTables):
        """Ghost-row troubled flags ← the owning neighbour block's interior
        edge flags (False at coarse-fine faces and for inactive slots;
        wall ghosts take the ADJACENT interior edge cell's flag — row 1 at
        the low wall, row r at the high wall, the rows the wall mirror in
        ghost_fill copies).  Stacked-layout strided addressing, like
        :meth:`ghost_fill`."""
        B = self.block
        r = self.factor
        dim = self.coarse.dim
        x = troubled
        nd = x.ndim

        for d in range(dim):
            stacked = d == dim - 1
            for side, (gpos, src) in enumerate(((0, r), (B - 1, 1))):
                nb = tables.neighbor[:, d, side]
                w = tables.wall[:, d, side]
                wall_src = 1 if side == 0 else r
                sl_g, sl_s = self._stacked_slices(nd, 0, d, gpos, src)
                sl_w = self._stacked_slices(nd, 0, d, gpos, wall_src)[1]
                if stacked:
                    from_fine = jnp.take(x[sl_s], nb, axis=-1)
                    ok, wm = nb >= 0, w
                else:
                    from_fine = self._m_take(x[sl_s], nb)
                    ok, wm = jnp.repeat(nb >= 0, B), jnp.repeat(w, B)
                x = x.at[sl_g].set(
                    jnp.where(wm, x[sl_w], ok & from_fine)
                )
        return x

    # ------------------------------------------------------- restriction

    def _restrict_pair(self, x, node_ax, block_ax):
        """Contract one (fine-node, r-subcell) axis pair with R → coarse
        nodes at ``node_ax``; the block axis is consumed."""
        x2 = jnp.moveaxis(x, (node_ax, block_ax), (0, 1))  # [n_f, r, ...]
        x2 = _einsum(
            "jki,ik...->j...", jnp.asarray(self._R, x.dtype), x2
        )
        return jnp.moveaxis(x2, 0, node_ax)

    def restrict_into(self, uc, fs, tables: CellPoolTables):
        """L2-project every block's interior onto its coarse cell."""
        c = self.coarse
        dim, r = c.dim, self.factor
        x = self.unstack(fs)
        nd = x.ndim
        for d in range(dim):
            sl = [slice(None)] * nd
            sl[self._block_axis(d)] = slice(1, 1 + r)
            x = x[tuple(sl)]
        # Contract block axes last-to-first so earlier positions stay valid.
        for d in reversed(range(dim)):
            x = self._restrict_pair(x, c.node_axis(d), self._block_axis(d))
        # x: [n^dim, V, M] — scatter onto the coarse grid (drop inactive).
        idx = self._cell_indices(tables)
        return uc.at[(Ellipsis,) + idx].set(x, mode="drop")

    def _cell_indices(self, tables: CellPoolTables, axis_override=None):
        """Per-axis [M] coarse-cell indices (OOB sentinel when inactive)."""
        c = self.coarse
        out = []
        for d in range(c.dim):
            ix = (
                axis_override[d]
                if axis_override is not None and axis_override[d] is not None
                else tables.coords[:, d]
            )
            out.append(jnp.where(tables.active, ix, c.grid_shape[d]))
        return tuple(out)

    # -------------------------------------------------------- refluxing

    def _boundary_flux_sample(self, f_fluxes):
        """Per-axis (lo, hi) block-boundary fine fluxes, transversely
        L2-projected to coarse faces: arrays ``[tn^(dim-1), V, M]``."""
        c = self.coarse
        dim, r = c.dim, self.factor
        out = []
        for d in range(dim):
            face = f_fluxes[d]  # [tn^(dim-1), V, *grid] (node axis d gone)
            # Un-merge the LAST grid axis (the stacked one) and move M to
            # the canonical position after V.
            B, M = self.block, self.capacity
            m_pos = dim  # tn axes: dim-1, then V → grid starts at dim
            x = face.reshape(face.shape[:-1] + (M, B))
            x = jnp.moveaxis(x, -2, m_pos)
            nd = x.ndim

            def block_ax(e, _m=m_pos):
                return _m + 1 + e

            pair = []
            for fidx in (0, r):  # low face (ghost0|int1), high (int r|ghost)
                sl = [slice(None)] * nd
                sl[block_ax(d)] = slice(fidx, fidx + 1)
                row = x[tuple(sl)]
                # Transverse interiors.
                for e in range(dim):
                    if e == d:
                        continue
                    sle = [slice(None)] * row.ndim
                    sle[block_ax(e)] = slice(1, 1 + r)
                    row = row[tuple(sle)]
                row = jnp.squeeze(row, axis=block_ax(d))
                # Contract transverse (node, subcell) pairs, last-to-first.
                trans = [e for e in range(dim) if e != d]
                for t in reversed(range(len(trans))):
                    e = trans[t]
                    bax = block_ax(e) - (1 if e > d else 0)  # d's axis gone
                    row = self._restrict_pair(row, t, bax)
                pair.append(row)  # [tn_c^(dim-1), V, M]
            out.append(tuple(pair))
        return out

    def _coarse_face(self, c_fluxes, tables, d, face_idx):
        """Coarse face-flux rows at every slot's (d, face_idx) face,
        gathered at the slot's transverse cell coords: [tn, V, M]."""
        c = self.coarse
        face = c_fluxes[d]  # [tn^(dim-1), V, *grid]
        m0 = c.dim  # grid axes start here
        idx = []
        M = tables.coords.shape[0]
        for e in range(c.dim):
            ix = face_idx if e == d else tables.coords[:, e]
            idx.append(jnp.mod(ix, c.grid_shape[e]).reshape((M,)))
        return face[(Ellipsis,) + tuple(idx)]  # [tn, V, M]

    def _apply_reflux(self, new_c, c_fluxes, agg, tables, dt):
        """Nodal surface correction of the coarse cell just outside every
        coarse–fine face (scatter-add; faces with refined neighbours and
        inactive slots drop via OOB indices)."""
        c = self.coarse
        ops = c.ops
        nd = new_c.ndim
        for d in range(c.dim):
            lam = dt / c._dxs[d]
            node_ax = c.node_axis(d)
            shape_i = [1] * (c.dim + 2)  # [n^dim, V, M] val layout
            shape_i[node_ax] = c.n_nodes
            phi1_w = jnp.asarray(ops.phi1 / ops.weights, new_c.dtype).reshape(shape_i)
            phi0_w = jnp.asarray(ops.phi0 / ops.weights, new_c.dtype).reshape(shape_i)
            for side in (0, 1):
                Ff = agg[d][side]
                if side == 0:
                    face_idx = tables.coords[:, d] - 1
                    cell_idx = tables.coords[:, d] - 1
                    sign, phi_w = -1.0, phi1_w
                else:
                    face_idx = tables.coords[:, d]
                    cell_idx = tables.coords[:, d] + 1
                    sign, phi_w = +1.0, phi0_w
                Fc = self._coarse_face(c_fluxes, tables, d, face_idx)
                delta = jnp.expand_dims(Ff - Fc, node_ax)  # [n^dim, V, M]
                vals = sign * lam * phi_w * delta
                is_cf = (
                    tables.active
                    & (tables.neighbor[:, d, side] < 0)
                    & ~tables.wall[:, d, side]
                )
                override = [None] * c.dim
                override[d] = jnp.where(
                    is_cf, jnp.mod(cell_idx, c.grid_shape[d]), c.grid_shape[d]
                )
                # _cell_indices drops inactive; the override drops
                # fine-neighbour faces too.
                idx = self._cell_indices(
                    tables._replace(
                        active=tables.active & is_cf
                    ),
                    axis_override=override,
                )
                new_c = new_c.at[(Ellipsis,) + idx].add(vals, mode="drop")
        return new_c

    # ----------------------------------------------------------------- step

    def step(self, uc, fs, tables: CellPoolTables, dt):
        """One coupled coarse step; jit once, reuse for every pattern."""
        c = self.coarse
        r = self.factor
        if self.reflux:
            new_c, c_fluxes = self.coarse_stepper.step(
                uc, dt, return_face_fluxes=True
            )
        else:
            new_c = self.coarse_stepper.step(uc, dt)
        up = self.stack(self.prolong_blocks(uc, tables.coords))
        dt_f = dt / r
        ghost_maps = self.ghost_index_map(tables)

        def substep(carry, _):
            f, acc = carry
            f = self.ghost_fill(f, up, tables, maps=ghost_maps)
            kw = {}
            if hasattr(self.fine_stepper, "troubled_mask"):
                # Limited fine level: ghost-row troubled flags must mirror
                # the owning neighbour block's interior flags (the stacked
                # wrap makes the candidate's ghost rows meaningless), else
                # the two sides of a fine-fine face can disagree on the
                # limiting decision and the face flux loses single-valuedness.
                kw["troubled_transform"] = lambda t: self._sync_troubled(
                    t, tables
                )
            if self.reflux:
                f2, f_fluxes = self.fine_stepper.step(
                    f, dt_f, return_face_fluxes=True, **kw
                )
                acc = jax.tree.map(
                    lambda a, b: a + b,
                    acc,
                    self._boundary_flux_sample(f_fluxes),
                )
            else:
                f2 = self.fine_stepper.step(f, dt_f, **kw)
            return (f2, acc), None

        if self.reflux:
            zero_faces = [
                jnp.zeros(
                    (c.n_nodes,) * (c.dim - 1)
                    + (c.n_vars,)
                    + self.fine.grid_shape,
                    fs.dtype,
                )
                for _ in range(c.dim)
            ]
            acc0 = jax.tree.map(
                jnp.zeros_like, self._boundary_flux_sample(zero_faces)
            )
        else:
            acc0 = 0.0
        (new_f, acc), _ = jax.lax.scan(substep, (fs, acc0), None, length=r)
        new_c = self.restrict_into(new_c, new_f, tables)
        if self.reflux:
            agg = jax.tree.map(lambda a: a / r, acc)
            new_c = self._apply_reflux(new_c, c_fluxes, agg, tables, dt)
        return new_c, new_f

    def run(self, uc, fs, tables: CellPoolTables, n_steps: int, dt):
        def body(carry, _):
            a, b = carry
            return self.step(a, b, tables, dt), None

        (uc, fs), _ = jax.lax.scan(body, (uc, fs), None, length=n_steps)
        return uc, fs

    # ---------------------------------------------------------------- regrid

    def regrid(self, uc, fs, old: CellPoolTables, new: CellPoolTables):
        """Pool for a NEW pattern: surviving cells keep their fine blocks,
        new cells prolong from the coarse solution.  Exact conservation
        across the event (restriction ran every step; L2 prolongation
        preserves cell means)."""
        oc, oa = np.asarray(old.coords), np.asarray(old.active)
        slot_of = {tuple(oc[m]): m for m in range(len(oa)) if oa[m]}
        nc, na = np.asarray(new.coords), np.asarray(new.active)
        match = np.array(
            [
                slot_of.get(tuple(nc[m]), -1) if na[m] else -1
                for m in range(len(na))
            ],
            np.int32,
        )
        prolonged = self.unstack(self.init_pool(uc, new))
        old_blocks = self.unstack(fs)
        keep_shape = [1] * prolonged.ndim
        keep_shape[self._m_axis] = self.capacity
        keep = jnp.asarray(match >= 0).reshape(keep_shape)
        carried = jnp.take(old_blocks, jnp.asarray(match), axis=self._m_axis)
        return self.stack(jnp.where(keep, carried, prolonged))


@dataclasses.dataclass
class DynamicADERDGPool(DynamicRunBase):
    """Criteria-driven tree re-gridding on the flagship scheme with ONE
    compiled chunk (the :class:`~exahype_jax.parallel.pool.DynamicRunBase`
    loop over :class:`ADERDGPoolRefinement`)."""

    solver: ADERDGSolver
    capacity: int
    criterion: Optional[object] = None
    rel_threshold: float = 0.5
    factor: int = 3
    reflux: bool = True
    #: Forwarded to :class:`ADERDGPoolRefinement` — e.g.
    #: ``lambda s: LimitedADERDG(s)`` for shock capturing per level.
    fine_factory: object = None
    coarse_factory: object = None

    def __post_init__(self):
        if self.criterion is None:
            from exahype_jax.models.aderdg_amr import cell_mean_jump_indicator

            self.criterion = cell_mean_jump_indicator
        self.pool = ADERDGPoolRefinement(
            self.solver, capacity=self.capacity,
            factor=self.factor, reflux=self.reflux,
            fine_factory=self.fine_factory,
            coarse_factory=self.coarse_factory,
        )
        self._criterion_subject = self.solver
        self._chunk = {}
