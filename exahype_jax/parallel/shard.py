"""Explicit multi-device ADER-DG stepping: ``shard_map`` + ``ppermute``.

GSPMD auto-partitioning covers the plain array program
(``ADERDGSolver.step`` jitted over a sharded state, see
``parallel/mesh.py``).  This module writes the same step out per shard: the
cell grid's axis 0 is sharded over a 1-D mesh, every stage of the step is
shard-local except the axis-0 neighbour access of the face stage, and that
access is a local roll plus a one-row ``lax.ppermute`` edge exchange.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from exahype_jax.parallel.mesh import PATCH_AXIS
from exahype_jax.utils.errors import SemanticError


def _ppermute_wire(slab, axis_name, perm, wire_dtype):
    """``ppermute`` with an optional reduced-precision WIRE format: the
    payload is cast to ``wire_dtype`` (e.g. bf16 — halving the bytes of
    every edge exchange) and restored to the compute dtype on receipt.
    Only the cross-device edge slabs are quantized; intra-shard data never
    loses precision."""
    if wire_dtype is None:
        return jax.lax.ppermute(slab, axis_name, perm)
    out = jax.lax.ppermute(slab.astype(wire_dtype), axis_name, perm)
    return out.astype(slab.dtype)


def _localize_dirichlet(solver, shard_info):
    """Wrap ``solver.dirichlet_fn`` so each shard reads ITS window of the
    globally-prescribed wall rows.  ``shard_info`` maps a sharded GRID axis to
    ``(mesh_axis_name, local_extent)``; the wrapper dynamic-slices the
    global row along every sharded transverse grid axis at
    ``axis_index * local_extent`` (the wall axis itself is the singleton
    row dimension and broadcast rows are shard-invariant).  Must be
    called inside ``shard_map`` (it reads ``jax.lax.axis_index``)."""
    base = solver.dirichlet_fn
    if base is None:
        return None
    dim = solver.dim

    def fn(axis, side):
        row = jnp.asarray(base(axis, side))
        for gax, (name, local) in shard_info.items():
            pos = dim + gax  # grid axis position in the face-row layout
            if gax == axis or pos >= row.ndim or row.shape[pos] <= 1:
                continue
            idx = jax.lax.axis_index(name)
            row = jax.lax.dynamic_slice_in_dim(
                row, idx * local, local, axis=pos
            )
        return row

    fn.basis = getattr(base, "basis", None)
    return fn


def _edge_shift(x, sh, axis, axis_name, n_shards, wire_dtype=None):
    """Periodic shift by one along a GRID axis that is sharded over
    ``axis_name``: local roll + ``ppermute`` of the one-row edge the
    neighbour shard owns (the roll wraps locally; the edge exchange fixes
    the shard boundary)."""
    n = x.shape[axis]
    rolled = jnp.roll(x, sh, axis=axis)
    if sh == -1:
        edge = jax.lax.slice_in_dim(x, 0, 1, axis=axis)  # my first row
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        recv = _ppermute_wire(edge, axis_name, perm, wire_dtype)
        return jax.lax.dynamic_update_slice_in_dim(rolled, recv, n - 1, axis)
    if sh == 1:
        edge = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)  # my last row
        perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        recv = _ppermute_wire(edge, axis_name, perm, wire_dtype)
        return jax.lax.dynamic_update_slice_in_dim(rolled, recv, 0, axis)
    raise SemanticError(f"edge shift supports +-1, got {sh}")


def make_sharded_xla_aderdg_step(
    solver,
    mesh: Mesh,
    axis_name: str = PATCH_AXIS,
    wire_dtype=None,
    cell_stage=None,
    return_face_fluxes: bool = False,
):
    """Multi-device ADER-DG step: the whole :meth:`ADERDGSolver.step` runs
    per shard under ``shard_map``.  Every stage is cell-local except the
    axis-0 neighbour access in the face stage, which goes through a
    one-row ``ppermute`` edge exchange, with wall ghosts gated to the
    shards owning a domain wall and Dirichlet rows localized to each
    shard's window.  ``wire_dtype`` (e.g. ``jnp.bfloat16``) quantizes the
    cross-device edge payload only (:func:`_ppermute_wire`).

    ``cell_stage``: optional factory ``local_solver -> cell_stage`` for
    the shard-local cell stage, e.g.
    ``lambda s: TritonADERDG(s).cell_stage`` for the fused GPU kernel
    (a ``pallas_call`` is opaque to GSPMD, so under ``shard_map`` it runs
    once per shard on the local block).

    ``return_face_fluxes=True`` makes ``step_fn`` return ``(new,
    [fhat_0, .., fhat_{d-1}])`` like ``ADERDGSolver.step``, each face-flux
    array sharded along grid axis 0 like the state (:class:`ShardedADERDG`
    wraps this for ``LimitedADERDG(accelerator=...)``).

    Returns ``(step_fn, sharding)``: jit ``step_fn(Q, dt)`` with ``Q``
    placed on ``sharding``.
    """
    n_shards = mesh.shape[axis_name]
    if solver.grid_shape[0] % n_shards != 0:
        raise SemanticError(
            f"grid axis 0 ({solver.grid_shape[0]}) must be divisible by "
            f"the mesh size ({n_shards})"
        )
    local_grid = (solver.grid_shape[0] // n_shards,) + tuple(
        solver.grid_shape[1:]
    )
    local_dirichlet = _localize_dirichlet(
        solver, {0: (axis_name, local_grid[0])}
    )
    local_solver = dataclasses.replace(
        solver, grid_shape=local_grid, dirichlet_fn=local_dirichlet
    )

    local_cell_stage = cell_stage(local_solver) if cell_stage else None

    shard_axis = solver.grid_axis(0)
    ndim = len(solver.state_shape)
    spec_list = [None] * ndim
    spec_list[shard_axis] = axis_name
    state_spec = PartitionSpec(*spec_list)
    sharding = NamedSharding(mesh, state_spec)
    # A face-flux array drops node axis d, so grid axis 0 sits one slot
    # earlier than in the state.
    face_spec = PartitionSpec(
        *(spec_list[: shard_axis - 1] + spec_list[shard_axis:])
    )

    def shift(x, sh, ax):
        return _edge_shift(x, sh, ax, axis_name, n_shards, wire_dtype)

    def local_step(Q_local, dt):
        idx = jax.lax.axis_index(axis_name)
        return local_solver.step(
            Q_local,
            jnp.asarray(dt, Q_local.dtype),
            return_face_fluxes=return_face_fluxes,
            axis0_shift=shift,
            axis0_wall_gates=(idx == 0, idx == n_shards - 1),
            cell_stage=local_cell_stage,
        )

    out_specs = (
        (state_spec, [face_spec] * solver.dim)
        if return_face_fluxes
        else state_spec
    )
    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(state_spec, PartitionSpec()),
        out_specs=out_specs,
        check_vma=False,
    )
    return step, sharding


class ShardedADERDG:
    """The sharded step as an accelerated stepper: ``.solver``,
    ``.sharding`` and ``.step(u, dt, return_face_fluxes)``, the interface
    ``LimitedADERDG(accelerator=...)`` takes.  The candidate step and its
    face fluxes run per shard under ``shard_map``
    (:func:`make_sharded_xla_aderdg_step`); the limiter's detection,
    gathered fallback and interface matching stay plain XLA over globally
    shaped arrays and GSPMD-partition around that region under the
    enclosing ``jit``.  This is how the fused GPU cell stage reaches a
    limited run on several devices: a bare ``TritonADERDG`` under GSPMD is
    one opaque ``pallas_call`` that GSPMD does not split."""

    def __init__(self, solver, mesh: Mesh, cell_stage=None):
        self.solver = solver
        self._plain, self.sharding = make_sharded_xla_aderdg_step(
            solver, mesh, cell_stage=cell_stage)
        self._fluxed, _ = make_sharded_xla_aderdg_step(
            solver, mesh, cell_stage=cell_stage, return_face_fluxes=True)

    def step(self, u, dt, return_face_fluxes: bool = False):
        if return_face_fluxes:
            return self._fluxed(u, dt)
        return self._plain(u, dt)
