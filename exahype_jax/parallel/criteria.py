"""Refinement criteria: where should the fine level live?

Host-side estimators consumed by the dynamic re-gridding loop
(``examples/dynamic_refinement.py``): map the coarse solution to a
per-patch scalar score, pick the patch box around the maximum.  All
estimators work on the assembled global field (``utils.output``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from exahype_jax.parallel.grid import PatchGrid
from exahype_jax.utils.output import assemble_global


def patchwise_scores(grid: PatchGrid, score_cells: np.ndarray) -> np.ndarray:
    """Reduce a per-cell score to per-patch maxima: [*grid_shape]."""
    P = grid.config.patch_size
    shape = []
    for g in grid.grid_shape:
        shape += [g, P]
    blocks = score_cells.reshape(shape)
    axes = tuple(range(1, 2 * grid.config.dim, 2))
    return blocks.max(axis=axes)


def gradient_indicator(grid: PatchGrid, Q, var: int = 0) -> np.ndarray:
    """Per-patch max gradient magnitude of one variable."""
    g = np.asarray(assemble_global(grid, Q))[..., var]
    grads = np.gradient(g)
    mag = np.sqrt(sum(gr**2 for gr in grads))
    return patchwise_scores(grid, mag)


def jump_indicator(grid: PatchGrid, Q, var: int = 0) -> np.ndarray:
    """Per-patch max absolute neighbour jump (cheap shock detector)."""
    g = np.asarray(assemble_global(grid, Q))[..., var]
    score = np.zeros_like(g)
    for ax in range(g.ndim):
        jump = np.abs(np.diff(g, axis=ax))
        pad_lo = [(0, 0)] * g.ndim
        pad_lo[ax] = (1, 0)
        pad_hi = [(0, 0)] * g.ndim
        pad_hi[ax] = (0, 1)
        score = np.maximum(score, np.pad(jump, pad_lo))
        score = np.maximum(score, np.pad(jump, pad_hi))
    return patchwise_scores(grid, score)


def region_around_max(
    scores: np.ndarray,
    grid_shape: tuple[int, ...],
    half_width: int = 1,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Clamped patch box of ±half_width around the highest-scoring patch."""
    idx = np.unravel_index(int(np.argmax(scores)), scores.shape)
    lo = tuple(max(int(i) - half_width, 0) for i in idx)
    hi = tuple(
        min(int(i) + half_width + 1, g) for i, g in zip(idx, grid_shape)
    )
    return lo, hi
