"""Solution output: legacy-VTK and NPZ writers.

The reference's generated code hooks into Peano's plotting observers
(``observers/PlotSolution.h`` include, ``CPPPrinter.py:328``); here the
equivalent is a small self-contained writer: interior patch data assembled
into a global uniform grid and written as legacy VTK STRUCTURED_POINTS
(readable by ParaView/VisIt) or compressed NPZ.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Sequence

import numpy as np


def assemble_global(grid, Q) -> np.ndarray:
    """Strip halos and tile patches into one global array ``[*cells, n_vars]``.

    Accepts AoS :class:`PatchGrid` state.
    """
    cfg = grid.config
    h, P = cfg.halo_size, cfg.patch_size
    Q = np.asarray(Q)
    interior = Q
    for d in range(cfg.dim):
        ax = cfg.dim + d
        sl = [slice(None)] * interior.ndim
        sl[ax] = slice(h, h + P)
        interior = interior[tuple(sl)]
    # [g0..gd, p..p, V] -> interleave grid and patch axes -> [g0*p, ..., V]
    order = []
    for d in range(cfg.dim):
        order += [d, cfg.dim + d]
    order.append(2 * cfg.dim)
    interleaved = np.transpose(interior, order)
    shape = tuple(g * P for g in grid.grid_shape) + (cfg.n_vars,)
    return interleaved.reshape(shape)


def disassemble_global(grid, Q, global_arr):
    """Inverse of :func:`assemble_global` for AoS grids: write the global
    cell field back into the interiors of the patch state (halos untouched).
    Works on jnp arrays (returns an updated copy)."""
    import jax.numpy as jnp

    cfg = grid.config
    h, P = cfg.halo_size, cfg.patch_size
    # [g0*P, ..., V] -> [g0, P, g1, P, ..., V] -> [g0..gd, P..P, V]
    split_shape = []
    for g in grid.grid_shape:
        split_shape += [g, P]
    split_shape.append(cfg.n_vars)
    arr = jnp.asarray(global_arr).reshape(split_shape)
    order = list(range(0, 2 * cfg.dim, 2)) + list(range(1, 2 * cfg.dim, 2))
    order.append(2 * cfg.dim)
    blocks = jnp.transpose(arr, order)  # [g.., P.., V]
    sl = [slice(None)] * (2 * cfg.dim + 1)
    for d in range(cfg.dim):
        sl[cfg.dim + d] = slice(h, h + P)
    return jnp.asarray(Q).at[tuple(sl)].set(blocks)


def write_npz(path, grid, Q, var_names: Optional[Sequence[str]] = None, **extra):
    """Compressed NPZ snapshot of the assembled global field."""
    data = assemble_global(grid, Q)
    names = list(var_names or [f"var{i}" for i in range(data.shape[-1])])
    arrays = {name: data[..., i] for i, name in enumerate(names)}
    arrays.update(extra)
    np.savez_compressed(path, **arrays)
    return pathlib.Path(path)


def write_vtk(
    path,
    grid,
    Q,
    var_names: Optional[Sequence[str]] = None,
    dx: float = 1.0,
    origin: Sequence[float] = (0.0, 0.0, 0.0),
):
    """Legacy-VTK STRUCTURED_POINTS file of the assembled global field.

    ``origin`` is the DOMAIN origin; the written VTK ORIGIN is offset by
    half a spacing so the cell-centered values render at cell centers."""
    data = assemble_global(grid, Q)
    cfg = grid.config
    dims = data.shape[:-1]
    n_vars = data.shape[-1]
    names = list(var_names or [f"var{i}" for i in range(n_vars)])

    vtk_dims = tuple(dims) + (1,) * (3 - cfg.dim)
    n_points = int(np.prod(vtk_dims))
    org = [
        origin[i] + (0.5 * dx if i < cfg.dim else 0.0) for i in range(3)
    ]

    lines = [
        "# vtk DataFile Version 3.0",
        "exahype_jax solution",
        "ASCII",
        "DATASET STRUCTURED_POINTS",
        f"DIMENSIONS {vtk_dims[0]} {vtk_dims[1]} {vtk_dims[2]}",
        f"ORIGIN {org[0]} {org[1]} {org[2]}",
        f"SPACING {dx} {dx} {dx}",
        f"POINT_DATA {n_points}",
    ]
    for i, name in enumerate(names):
        field = data[..., i]
        # VTK expects x fastest: transpose so the first axis varies fastest.
        flat = np.transpose(field).reshape(-1)
        lines.append(f"SCALARS {name} double 1")
        lines.append("LOOKUP_TABLE default")
        lines.extend(f"{v:.17g}" for v in flat)
    out = pathlib.Path(path)
    out.write_text("\n".join(lines) + "\n")
    return out


def assemble_pool(pool, fine_Q, tables, fill=np.nan) -> np.ndarray:
    """Assemble a tree-pool fine state (``parallel/pool.py``) onto the
    fine-resolution global cell array ``[*fine_cells, n_vars]`` — ``fill``
    where unrefined.  For plotting / NPZ / VTK of scattered refinement."""
    cfg = pool.coarse.grid.config
    P, h = cfg.patch_size, cfg.halo_size
    r = pool.factor
    n_f = tuple(g * P * r for g in pool.coarse.grid.grid_shape)
    out = np.full(n_f + (cfg.n_vars,), fill)
    coords = np.asarray(tables.coords)
    active = np.asarray(tables.active)
    fq = np.asarray(fine_Q)
    for m in range(len(active)):
        if not active[m]:
            continue
        sl = tuple(
            slice(coords[m, d] * P, (coords[m, d] + 1) * P)
            for d in range(cfg.dim)
        )
        interior = fq[m]
        for d in range(cfg.dim):
            s = [slice(None)] * interior.ndim
            s[d] = slice(h, h + P)
            interior = interior[tuple(s)]
        out[sl] = interior
    return out


def write_seismograms(
    path,
    times,
    positions,
    values,
    var_names: Optional[Sequence[str]] = None,
    **extra,
):
    """Receiver time series (the ExaHyPE probe/seismogram output): NPZ with
    ``times [T]``, ``positions [R, dim]`` and one ``[T, R]`` array per
    variable — the shape :meth:`TracerAdvector.trajectories` and the
    example receiver scans produce (``values [T, R, n_vars]``)."""
    values = np.asarray(values)
    names = list(var_names or [f"var{i}" for i in range(values.shape[-1])])
    if len(names) != values.shape[-1]:
        raise ValueError(
            f"{len(names)} names for {values.shape[-1]} variables"
        )
    arrays = {name: values[..., i] for i, name in enumerate(names)}
    arrays["times"] = np.asarray(times)
    arrays["positions"] = np.asarray(positions)
    arrays.update(extra)
    np.savez_compressed(path, **arrays)
    return pathlib.Path(path)


# --------------------------------------------------------------- ADER-DG


def aderdg_cell_means(solver, u) -> np.ndarray:
    """Quadrature cell means of an :class:`ADERDGSolver` state →
    ``[*grid, n_vars]`` (the FV-style field the VTK writer consumes)."""
    w = np.asarray(solver.ops.weights)
    out = np.asarray(u)
    for d in reversed(range(solver.dim)):
        out = np.tensordot(w, out, axes=([0], [solver.node_axis(d)]))
    # out: [n_vars, *grid] -> [*grid, n_vars]
    return np.moveaxis(out, 0, -1)


def aderdg_resample(solver, u, points_per_cell: int) -> np.ndarray:
    """Sample the DG polynomial on a uniform sub-grid (``points_per_cell``
    equispaced points per cell per axis, cell-centered) →
    ``[*grid·points_per_cell, n_vars]``.  The high-resolution plotting
    export (ExaHyPE's plotter-resolution analogue): unlike cell means this
    shows the intra-cell polynomial structure."""
    from exahype_jax.models.dg import lagrange_eval

    nodes = np.asarray(solver.ops.nodes)
    s = points_per_cell
    xs = (np.arange(s) + 0.5) / s
    L = np.stack([lagrange_eval(nodes, float(x)) for x in xs])  # [s, n]
    out = np.asarray(u)
    # Replace each node axis by a sample axis, then interleave with grid.
    for d in range(solver.dim):
        out = np.moveaxis(
            np.tensordot(L, out, axes=([1], [d])), 0, d
        )
    # out: [s.., n_vars, *grid]
    var_ax = solver.dim
    order = []
    for d in range(solver.dim):
        order += [var_ax + 1 + d, d]  # grid-major, sample-minor
    order.append(var_ax)
    out = np.transpose(out, order)
    shape = tuple(g * s for g in solver.grid_shape) + (solver.n_vars,)
    return out.reshape(shape)


def write_vtk_aderdg(
    path,
    solver,
    u,
    var_names: Optional[Sequence[str]] = None,
    points_per_cell: int = 1,
    origin: Sequence[float] = (0.0, 0.0, 0.0),
):
    """Legacy-VTK STRUCTURED_POINTS of an ADER-DG state: cell means
    (``points_per_cell=1``) or the polynomial resampled at
    ``points_per_cell`` samples/cell/axis."""
    if points_per_cell == 1:
        data = aderdg_cell_means(solver, u)
    else:
        data = aderdg_resample(solver, u, points_per_cell)
    dims = data.shape[:-1]
    n_vars = data.shape[-1]
    names = list(var_names or [f"var{i}" for i in range(n_vars)])
    if len(names) != n_vars:
        raise ValueError(f"{len(names)} names for {n_vars} variables")
    dxs = tuple(
        solver._dxs[d] / points_per_cell for d in range(solver.dim)
    ) + (1.0,) * (3 - solver.dim)
    vtk_dims = tuple(dims) + (1,) * (3 - solver.dim)
    n_points = int(np.prod(vtk_dims))
    # samples are cell-/subcell-centered: offset ORIGIN by half a spacing
    org = [
        origin[i] + (0.5 * dxs[i] if i < solver.dim else 0.0)
        for i in range(3)
    ]
    lines = [
        "# vtk DataFile Version 3.0",
        "exahype_jax ADER-DG solution",
        "ASCII",
        "DATASET STRUCTURED_POINTS",
        f"DIMENSIONS {vtk_dims[0]} {vtk_dims[1]} {vtk_dims[2]}",
        f"ORIGIN {org[0]} {org[1]} {org[2]}",
        f"SPACING {dxs[0]} {dxs[1]} {dxs[2]}",
        f"POINT_DATA {n_points}",
    ]
    for i, name in enumerate(names):
        flat = np.transpose(data[..., i]).reshape(-1)
        lines.append(f"SCALARS {name} double 1")
        lines.append("LOOKUP_TABLE default")
        lines.extend(f"{v:.17g}" for v in flat)
    out = pathlib.Path(path)
    out.write_text("\n".join(lines) + "\n")
    return out
