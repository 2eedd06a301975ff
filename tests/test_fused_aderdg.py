"""The fused GPU cell stage (``models/aderdg_triton.py``) in the Pallas
interpreter, against the plain reference ``ADERDGSolver.cell_stage``.

The kernel itself compiles only on the card (``chip_smoke.py`` checks it
there at 64³); these tests cover its arithmetic, the padding of node and
cell axes, the choice of block size, the point-local flux evaluation and
the solvers it refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exahype_jax.models.aderdg import (
    ADERDGSolver,
    euler_physics,
    euler_reflect,
    euler_reflect_flux,
    wrap_var_last,
)
from exahype_jax.models.aderdg_triton import TritonADERDG, pointwise
from exahype_jax.models.limiter import LimitedADERDG, euler_admissible
from exahype_jax.utils.errors import LoweringError

GRIDS = {2: (4, 3), 3: (2, 3, 2)}


def _solver(system, dim, order, **kw):
    if system == "euler":
        flux, eig = euler_physics(dim=dim, n_real=dim + 2)
        n_vars = dim + 2
    else:
        a = (1.0, -0.5, 0.25)

        def flux(Q, axis, var_axis):
            return a[axis] * Q

        def eig(Q, axis, var_axis):
            shape = Q.shape[:var_axis] + Q.shape[var_axis + 1:]
            return jnp.full(shape, abs(a[axis]), Q.dtype)

        n_vars = 2
    return ADERDGSolver(dim=dim, order=order, n_vars=n_vars,
                        grid_shape=GRIDS[dim], flux_fn=flux,
                        max_eigenvalue_fn=eig, dx=0.1, **kw)


def _state(solver, seed=0):
    """Order-one values with ±10 % nodal noise: rough enough to exercise
    every operator entry, mild enough that the Picard iteration contracts
    at the test's dt (so rounding-order differences stay at rounding)."""
    Q = np.random.default_rng(seed).uniform(0.9, 1.1, solver.state_shape)
    if solver.n_vars == solver.dim + 2:  # Euler: keep the pressure positive
        sl = (slice(None),) * solver.var_axis + (solver.dim + 1,)
        Q[sl] += 5.0
    return jnp.asarray(Q)


def _max_diff(got, want):
    return max(float(jnp.max(jnp.abs(a - b)))
               for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


@pytest.mark.parametrize("system", ["euler", "advection"])
@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("dim", [2, 3])
def test_cell_stage_matches_reference(dim, order, system):
    solver = _solver(system, dim, order)
    Q = _state(solver)
    fused = TritonADERDG(solver, interpret=True)
    want = solver.cell_stage(Q, 5e-4)
    got = fused.cell_stage(Q, 5e-4)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert _max_diff(got, want) < 1e-12


def test_step_with_walls_matches_reference():
    """Walls live in the XLA face stage, so the fused step composes."""
    solver = _solver("euler", 2, 3, boundary="reflective",
                     reflect_fn=euler_reflect(2),
                     reflect_flux_fn=euler_reflect_flux(2))
    Q = _state(solver)
    fused = TritonADERDG(solver, interpret=True)
    want = solver.run(Q, 2, 5e-4)
    got = fused.run(Q, 2, 5e-4)
    assert float(jnp.max(jnp.abs(got - want))) < 1e-12


def test_limiter_face_fluxes_through_fused_step():
    """``return_face_fluxes`` through ``LimitedADERDG(accelerator=...)``:
    the candidate and the face fluxes the interface matching consumes."""
    solver = _solver("euler", 2, 2)
    x = np.asarray(solver.nodes_meshgrid()[0])
    left = np.broadcast_to(np.squeeze(x, solver.var_axis) < 0.2,
                           _state(solver).shape[:2] + solver.grid_shape)
    rho = np.where(left, 1.0, 0.125)
    Q = jnp.asarray(np.stack([rho, 0 * rho, 0 * rho,
                              np.where(left, 2.5, 0.25)], axis=solver.var_axis))
    fused = TritonADERDG(solver, interpret=True)
    cand, fluxes = fused.step(Q, 1e-3, return_face_fluxes=True)
    cand_ref, fluxes_ref = solver.step(Q, 1e-3, return_face_fluxes=True)
    assert _max_diff((cand, fluxes), (cand_ref, fluxes_ref)) < 1e-12
    plain = LimitedADERDG(solver, admissible=euler_admissible(dim=2))
    fast = LimitedADERDG(solver, admissible=euler_admissible(dim=2),
                         accelerator=fused)
    assert float(jnp.max(jnp.abs(fast.step(Q, 1e-3) - plain.step(Q, 1e-3)))) < 1e-12


def _ncp(Q, gradQ, axis, var_axis):
    return 0.5 * gradQ


@pytest.mark.parametrize("kw,what", [
    (dict(predictor_mode="ck"), "Cauchy"),
    (dict(ncp_fn=_ncp), "non-conservative"),
    (dict(visc_flux_fn=lambda Q, g, a, v: 0 * Q,
          visc_eigenvalue_fn=lambda Q, a, v: jnp.zeros(Q.shape[:v] + Q.shape[v + 1:])),
     "viscous"),
    (dict(source_fn=lambda Q, v: 0 * Q), "source"),
])
def test_refuses_unsupported_solvers(kw, what):
    solver = _solver("advection", 2, 2, **kw)
    with pytest.raises(LoweringError, match=what):
        TritonADERDG(solver)


def test_block_cells_from_shapes_and_padding():
    """The default block gives one warp 128 node points; cells that do not
    fill the last block are padded (edge-replicated) and cut off again."""
    p3 = _solver("euler", 3, 3)
    assert TritonADERDG(p3).block_cells == 2       # 64 points per cell
    assert TritonADERDG(_solver("euler", 2, 3)).block_cells == 8  # 16 points
    assert TritonADERDG(_solver("euler", 3, 4)).block_cells == 1  # 8³ padded
    with pytest.raises(LoweringError, match="power of two"):
        TritonADERDG(p3, block_cells=3)
    Q = _state(p3)  # 12 cells, not a multiple of 8
    fused = TritonADERDG(p3, block_cells=8, interpret=True)
    assert _max_diff(fused.cell_stage(Q, 1e-3), p3.cell_stage(Q, 1e-3)) < 1e-12


def test_pointwise_replays_a_var_last_flux():
    """A ``wrap_var_last`` callback (transposes, slices, concatenation,
    reductions) traced at one point and replayed on per-variable tiles."""

    def flux(Q, axis):  # var axis last
        speed = jnp.sum(Q[..., :2], axis=-1, keepdims=True)
        return jnp.concatenate([speed * Q[..., 1:], jnp.max(Q, -1, keepdims=True)], -1)

    fn = wrap_var_last(flux)
    tiles = [jnp.asarray(np.random.default_rng(k).random((4, 3))) for k in range(3)]
    got = pointwise(lambda q: fn(q, 0, 0), 3, jnp.float64)(tiles)
    want = fn(jnp.stack(tiles), 0, 0)
    for k in range(3):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-15)


def test_pointwise_rejects_non_local_callbacks():
    with pytest.raises(LoweringError, match="cumsum"):
        pointwise(lambda q: jnp.cumsum(q), 3, jnp.float32)([jnp.ones(4)] * 3)
