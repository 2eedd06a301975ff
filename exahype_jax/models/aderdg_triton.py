"""Fused ADER-DG cell stage: one Pallas kernel for the GPU, through Triton.

The plain cell stage (:meth:`ADERDGSolver.cell_stage`) builds a space-time
array ``q`` four times the state at p3 and makes XLA sweep it, and the
time-averaged fluxes, many times per step.  Here one kernel program (one
warp) owns a few cells and keeps ``q``, the fluxes and every Picard
intermediate in registers: it reads the state once and writes the
volume-updated state and the face-extrapolated time averages once.  The
Riemann solve and surface update stay in XLA (:meth:`ADERDGSolver.step`
with ``cell_stage=``), so walls, the limiter's ``return_face_fluxes``
contract and sharding work unchanged.

Layout inside the kernel: the state ``[n.., V, *grid]`` is viewed as
``(n^d, V, cells)`` (a free reshape); a program loads, per variable, a
``(n^d, block_cells)`` tile.  Triton wants power-of-two tensors, so the node
axes are padded to the next power of two (edge-replicated, so padded points
hold admissible states; the padded operator entries are zero) and the cell
axis to a multiple of the block.  Contractions along a node axis are
broadcast-multiply-reduce over that axis on the CUDA cores: at K = n ≤ 8 no
tensor-core instruction applies, and TF32 would break the f32 contract.

The flux callback ``flux_fn(Q, axis, var_axis)`` is traced once at a single
point (a ``(V,)`` array) and its jaxpr is replayed on the per-variable
tiles (:func:`pointwise`), so any point-local flux runs in the kernel
unchanged.

Flux-form systems only: NCP, viscous, source, fused-RHS and CK solvers
raise :class:`LoweringError` and run on :class:`ADERDGSolver` itself.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from exahype_jax.models.aderdg import ADERDGSolver
from exahype_jax.utils.errors import LoweringError


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


# ------------------------------------------------- point-local callbacks

_UNARY = {
    "neg": jnp.negative, "abs": jnp.abs, "sqrt": jnp.sqrt, "rsqrt": jax.lax.rsqrt,
    "exp": jnp.exp, "log": jnp.log, "sign": jnp.sign, "square": jnp.square,
    "tanh": jnp.tanh, "sin": jnp.sin, "cos": jnp.cos, "log1p": jnp.log1p,
    "expm1": jnp.expm1, "cbrt": jnp.cbrt, "not": jnp.logical_not,
    "copy": lambda x: x, "copy_p": lambda x: x, "stop_gradient": lambda x: x,
}
_BINARY = {
    "add": jnp.add, "sub": jnp.subtract, "mul": jnp.multiply,
    "div": jnp.divide, "max": jnp.maximum, "min": jnp.minimum,
    "pow": jnp.power, "atan2": jnp.arctan2, "eq": jnp.equal,
    "ne": jnp.not_equal, "lt": jnp.less, "le": jnp.less_equal,
    "gt": jnp.greater, "ge": jnp.greater_equal, "and": jnp.logical_and,
    "or": jnp.logical_or,
}


def _elementwise(f, *arrays):
    """Apply ``f`` to the elements of broadcast object arrays."""
    arrays = np.broadcast_arrays(*arrays)
    out = np.empty(arrays[0].shape, object)
    for idx in np.ndindex(out.shape):
        out[idx] = f(*(a[idx] for a in arrays))
    return out


def _as_objects(value):
    arr = np.asarray(value)
    out = np.empty(arr.shape, object)
    for idx in np.ndindex(arr.shape):
        out[idx] = arr[idx].item()
    return out


def _reduce(arr, axes, f):
    keep = [a for a in range(arr.ndim) if a not in axes]
    moved = np.transpose(arr, keep + list(axes))
    flat = moved.reshape(moved.shape[: len(keep)] + (-1,))
    out = np.empty(flat.shape[:-1], object)
    for idx in np.ndindex(out.shape):
        out[idx] = functools.reduce(f, flat[idx])
    return out


def _eval_jaxpr(jaxpr, consts, args):
    env = {}

    def read(v):
        if isinstance(v, jax.extend.core.Literal):
            return _as_objects(v.val)
        return env[v]

    for var, val in zip(jaxpr.constvars, consts):
        env[var] = _as_objects(val)
    for var, val in zip(jaxpr.invars, args):
        env[var] = val
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        ins = [read(v) for v in eqn.invars]
        p = eqn.params
        if name in _UNARY:
            outs = [_elementwise(_UNARY[name], *ins)]
        elif name in _BINARY:
            outs = [_elementwise(_BINARY[name], *ins)]
        elif name == "integer_pow":
            outs = [_elementwise(lambda x: x ** p["y"], *ins)]
        elif name == "convert_element_type":
            dt = p["new_dtype"]
            outs = [_elementwise(
                lambda x: x.astype(dt) if hasattr(x, "astype") else x, *ins)]
        elif name == "select_n":
            def select(pred, *cases):
                if isinstance(pred, (bool, int, np.bool_, np.integer)):
                    return cases[int(pred)]
                if len(cases) != 2:
                    raise LoweringError("select_n with more than two cases")
                return jnp.where(pred, cases[1], cases[0])
            outs = [_elementwise(select, *ins)]
        elif name == "slice":
            strides = p["strides"] or (1,) * len(p["start_indices"])
            sl = tuple(slice(s, e, k) for s, e, k in
                       zip(p["start_indices"], p["limit_indices"], strides))
            outs = [ins[0][sl]]
        elif name == "squeeze":
            outs = [np.squeeze(ins[0], axis=tuple(p["dimensions"]))]
        elif name == "reshape":
            outs = [ins[0].reshape(p["new_sizes"])]
        elif name == "broadcast_in_dim":
            x = ins[0]
            shape = p["shape"]
            expanded = np.empty([1] * len(shape), object).reshape(
                [shape[d] if d in p["broadcast_dimensions"] else 1
                 for d in range(len(shape))]
                if x.ndim else [1] * len(shape)
            )
            expanded[...] = x.reshape(expanded.shape)
            outs = [np.broadcast_to(expanded, shape)]
        elif name == "concatenate":
            outs = [np.concatenate(ins, axis=p["dimension"])]
        elif name == "transpose":
            outs = [np.transpose(ins[0], p["permutation"])]
        elif name == "rev":
            outs = [np.flip(ins[0], axis=tuple(p["dimensions"]))]
        elif name == "reduce_sum":
            outs = [_reduce(ins[0], tuple(p["axes"]), jnp.add)]
        elif name == "reduce_max":
            outs = [_reduce(ins[0], tuple(p["axes"]), jnp.maximum)]
        elif name == "reduce_min":
            outs = [_reduce(ins[0], tuple(p["axes"]), jnp.minimum)]
        elif name in ("jit", "pjit", "closed_call", "core_call", "remat"):
            sub = p.get("jaxpr") or p.get("call_jaxpr")
            outs = _eval_jaxpr(sub.jaxpr, sub.consts, ins)
        elif name in ("custom_jvp_call", "custom_vjp_call"):
            sub = p["call_jaxpr"]
            outs = _eval_jaxpr(sub.jaxpr, sub.consts, ins)
        else:
            raise LoweringError(
                f"the fused cell stage cannot evaluate primitive {name!r} of "
                "the flux callback point by point"
            )
        for var, val in zip(eqn.outvars, outs):
            env[var] = val
    return [read(v) for v in jaxpr.outvars]


def pointwise(fn: Callable, n_vars: int, dtype) -> Callable:
    """Trace ``fn`` (a map from a ``(n_vars,)`` state to a ``(n_vars,)``
    result) at one point, and return ``apply(tiles) -> tiles`` evaluating
    it on a list of ``n_vars`` equally shaped arrays, one per variable."""
    closed = jax.make_jaxpr(fn)(jnp.zeros((n_vars,), dtype))

    def apply(tiles):
        arr = np.empty((n_vars,), object)
        for k, t in enumerate(tiles):
            arr[k] = t
        (out,) = _eval_jaxpr(closed.jaxpr, closed.consts, [arr])
        if out.shape != (n_vars,):
            raise LoweringError(
                f"flux callback returned shape {out.shape} at one point, "
                f"expected ({n_vars},)"
            )
        return list(out)

    return apply


# ----------------------------------------------------------------- solver


class TritonADERDG:
    """:class:`ADERDGSolver` with the fused GPU cell stage.

    One kernel program, one warp, owns ``block_cells`` cells (a power of
    two; ``None`` gives the warp 128 node points).  ``interpret=True`` runs
    the kernel in the Pallas interpreter (CPU tests); it is never chosen
    automatically."""

    def __init__(self, solver: ADERDGSolver, block_cells: Optional[int] = None,
                 interpret: bool = False):
        for what, bad in (
            ("the Cauchy–Kovalewski predictor", solver.predictor_mode == "ck"),
            ("non-conservative products", solver.ncp_fn is not None),
            ("viscous fluxes", solver.visc_flux_fn is not None),
            ("source terms", solver.source_fn is not None),
            ("fused right-hand sides", solver.rhs_all_fn is not None),
            ("reuse_last_flux", solver.reuse_last_flux),
        ):
            if bad:
                raise LoweringError(
                    f"the fused GPU cell stage does not support {what}; "
                    "step the ADERDGSolver itself"
                )
        self.solver = solver
        self.interpret = interpret
        self.n_pad = _pow2(solver.n_nodes)
        if block_cells is None:
            block_cells = max(1, 128 // self.n_pad**solver.dim)
        if block_cells != _pow2(block_cells):
            raise LoweringError(
                f"block_cells must be a power of two, got {block_cells}"
            )
        self.block_cells = int(block_cells)

    # -- the rest of the solver surface is the base solver's
    def dofs(self) -> int:
        return self.solver.dofs()

    def cfl_dt(self, u, cfl: float | None = None):
        return self.solver.cfl_dt(u, cfl)

    def total_mass(self, u):
        return self.solver.total_mass(u)

    def step(self, u, dt, return_face_fluxes: bool = False):
        return self.solver.step(u, dt, return_face_fluxes=return_face_fluxes,
                                cell_stage=self.cell_stage)

    def run(self, u, n_steps: int, dt):
        def body(carry, _):
            return self.step(carry, dt), None

        out, _ = jax.lax.scan(body, u, None, length=n_steps)
        return out

    # -- the kernel
    def _kernel(self, dtype):
        sol = self.solver
        d, V, n = sol.dim, sol.n_vars, sol.n_nodes
        npw, bc = self.n_pad, self.block_cells
        n_pts = npw**d
        ops = sol.ops
        w = [float(v) for v in ops.weights]
        k1inv = np.asarray(ops.K1inv, np.float64)
        # Picard update in streaming form: with M = K1inv·diag(w) and
        # c = K1inv·θ(0), q_{k+1}[t] = c_t u − Σ_s M[t, s] g(q_k[s]), where
        # g(q) = Σ_e λ_e ∂_e F_e(q); each time slice's divergence is folded
        # into every accumulator as soon as it exists.
        c = (k1inv @ np.asarray(ops.phi0, np.float64)).tolist()
        M = (k1inv * np.asarray(ops.weights, np.float64)[None, :]).tolist()
        inv_dx = [1.0 / h for h in sol._dxs]
        fluxes = [
            pointwise(functools.partial(
                lambda q, e: sol.flux_fn(q, e, 0), e=e), V, dtype)
            for e in range(d)
        ]

        def split(x, e):
            """``(n_pts, bc)`` tile -> ``(pre, npw, post, bc)`` around node
            axis ``e``."""
            return x.reshape(npw**e, npw, npw ** (d - 1 - e), bc)

        def apply(mat, x, e):
            """Contract ``mat[i, j] x[.., j, ..]`` along node axis ``e``."""
            y = jnp.sum(mat.reshape(1, npw, npw, 1, 1)
                        * jnp.expand_dims(split(x, e), 1), axis=2)
            return y.reshape(n_pts, bc)

        def project(vec, x, e):
            """Contract ``vec[j] x[.., j, ..]``: the face along axis ``e``."""
            y = jnp.sum(vec.reshape(1, npw, 1, 1) * split(x, e), axis=1)
            return y.reshape(n_pts // npw, bc)

        def kernel(dt_ref, mats_ref, phi_ref, u_ref, new_ref, *face_refs):
            dt = dt_ref[...]
            D, Kvol = mats_ref[0], mats_ref[1]
            phi = (phi_ref[0], phi_ref[1])
            lam = [dt * inv_dx[e] for e in range(d)]
            u = [u_ref[:, v, :] for v in range(V)]

            def div_flux(q_s):
                out = None
                for e in range(d):
                    F = fluxes[e](q_s)
                    terms = [lam[e] * apply(D, F[v], e) for v in range(V)]
                    out = terms if out is None else [
                        a + b for a, b in zip(out, terms)]
                return out

            def picard(_, flat):
                q = [flat[t * V:(t + 1) * V] for t in range(n)]
                acc = [[c[t] * u[v] for v in range(V)] for t in range(n)]
                for s in range(n):
                    g = div_flux(q[s])
                    acc = [[acc[t][v] - M[t][s] * g[v] for v in range(V)]
                           for t in range(n)]
                return tuple(x for row in acc for x in row)

            # Iteration 0: every time slice of q is u, so g is computed once.
            g0 = div_flux(u)
            q0 = tuple(c[t] * u[v] - sum(M[t]) * g0[v]
                       for t in range(n) for v in range(V))
            flat = jax.lax.fori_loop(1, sol.picard_iters, picard, q0)
            q = [flat[t * V:(t + 1) * V] for t in range(n)]
            qbar = [sum(w[t] * q[t][v] for t in range(n)) for v in range(V)]
            new = list(u)
            for e in range(d):
                F = [fluxes[e](q[t]) for t in range(n)]
                fbar = [sum(w[t] * F[t][v] for t in range(n)) for v in range(V)]
                q_lo, q_hi, f_lo, f_hi = face_refs[4 * e:4 * e + 4]
                for v in range(V):
                    new[v] = new[v] + lam[e] * apply(Kvol, fbar[v], e)
                    q_lo[:, v, :] = project(phi[0], qbar[v], e)
                    q_hi[:, v, :] = project(phi[1], qbar[v], e)
                    f_lo[:, v, :] = project(phi[0], fbar[v], e)
                    f_hi[:, v, :] = project(phi[1], fbar[v], e)
            for v in range(V):
                new_ref[:, v, :] = new[v]

        return kernel

    def cell_stage(self, u, dt):
        """Same contract as :meth:`ADERDGSolver.cell_stage`."""
        sol = self.solver
        d, V, n = sol.dim, sol.n_vars, sol.n_nodes
        npw, bc = self.n_pad, self.block_cells
        grid = tuple(sol.grid_shape)
        cells = math.prod(grid)
        padded = math.ceil(cells / bc) * bc
        x = u
        if npw != n:
            x = jnp.pad(x, [(0, npw - n)] * d + [(0, 0)] * (1 + d), mode="edge")
        x = x.reshape(npw**d, V, cells)
        if padded != cells:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, padded - cells)), mode="edge")
        mats = np.zeros((2, npw, npw))
        mats[0, :n, :n] = np.asarray(sol.ops.D)
        mats[1, :n, :n] = np.asarray(sol.ops.Kvol)
        phi = np.zeros((2, npw))
        phi[0, :n] = np.asarray(sol.ops.phi0)
        phi[1, :n] = np.asarray(sol.ops.phi1)
        dtv = jnp.reshape(jnp.asarray(dt, u.dtype), (1,))
        state = pl.BlockSpec((npw**d, V, bc), lambda i: (0, 0, i))
        face = pl.BlockSpec((npw ** (d - 1), V, bc), lambda i: (0, 0, i))
        kwargs = {}
        if not self.interpret:
            kwargs = dict(
                backend="triton",
                compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
            )
        new, *faces = pl.pallas_call(
            self._kernel(u.dtype),
            out_shape=[jax.ShapeDtypeStruct(x.shape, u.dtype)] + [
                jax.ShapeDtypeStruct((npw ** (d - 1), V, padded), u.dtype)
            ] * (4 * d),
            grid=(padded // bc,),
            in_specs=[
                pl.BlockSpec((1,), lambda i: (0,)),
                pl.BlockSpec((2, npw, npw), lambda i: (0, 0, 0)),
                pl.BlockSpec((2, npw), lambda i: (0, 0)),
                state,
            ],
            out_specs=[state] + [face] * (4 * d),
            interpret=self.interpret,
            name="aderdg_cell_stage",
            **kwargs,
        )(dtv, jnp.asarray(mats, u.dtype), jnp.asarray(phi, u.dtype), x)

        def unpad(y, k):
            y = y[..., :cells].reshape((npw,) * k + (V,) + grid)
            return y[(slice(0, n),) * k] if npw != n else y

        names = ("q_lo", "q_hi", "f_lo", "f_hi")
        return unpad(new, d), [
            {k: unpad(faces[4 * e + j], d - 1) for j, k in enumerate(names)}
            for e in range(d)
        ]
