"""JAX backend: lower a kernel spec to a jittable patch-update function.

This is the analogue of the reference's MLIR backend
(``exahype/printers/MLIRPrinter.py`` + ``exahype/SymPyToMLIR.py:1282-1299``):
instead of wrapping every SymPy node in an xDSL lowering class and emitting
``scf.for``/``memref`` text, the statement list is evaluated directly into a
traced JAX program —

- every nested statement loop becomes one vectorized array operation over the
  statement's loop region (static slices; no data-dependent control flow, so
  XLA fuses adjacent statements);
- the ``patch`` loop is the leading array axis (batched; shardable over a
  device mesh);
- halos are array padding; stencil offsets are shifted static slices;
- typed external functions are inlined via their ``jax_impl`` and vmapped
  over the cell axes — pointer-to-struct parameters arrive as per-cell
  variable vectors, matching the reference's C ABI convention
  (``Unit test/Functions.h:1-3``) but traceable and differentiable;
- in-place AoS mutation becomes functional ``.at[].set`` updates whose
  read-after-write order across statements is preserved exactly, which is
  what makes 1e-12 differential parity against the native backend possible.

Loop bounds come from the single authoritative bounds module
(:mod:`exahype_jax.frontend.bounds`); default policy ``"sound"``, with
``"golden"`` available for reference-exact parity runs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import sympy
from sympy.core.function import AppliedUndef

from exahype_jax.backends.base import CodePrinter
from exahype_jax.frontend.bounds import DEFAULT_POLICY, Policy, statement_ranges
from exahype_jax.frontend.dataflow import validate_dataflow
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.frontend.statements import Statement, StatementKind
from exahype_jax.frontend.typed_function import TypedFunction
from exahype_jax.utils.errors import LoweringError

# Tag constants for evaluated values.
_SCALAR = "scalar"  # python/jax scalar
_FIELD = "field"  # [patch, *spatial] array (no var axis)
_VFIELD = "vfield"  # [patch, *spatial, var] array

#: SymPy elementary functions → jnp equivalents, for expressions that use
#: math directly instead of external callbacks.
_SYMPY_FUNCS: dict[type, Callable] = {
    sympy.Abs: jnp.abs,
    sympy.sqrt: jnp.sqrt,
    sympy.exp: jnp.exp,
    sympy.log: jnp.log,
    sympy.sin: jnp.sin,
    sympy.cos: jnp.cos,
    sympy.tan: jnp.tan,
    sympy.sign: jnp.sign,
}


class JAXPrinter(CodePrinter):
    """Lower a :class:`KernelBuilder` spec to a JAX function.

    ``build()`` returns ``fn(Q, *runtime_scalars, params=None) -> Q`` where
    ``Q`` has shape ``[n_patches, extent, extent(, extent), n_vars]`` and the
    runtime scalars follow the kernel's declared input order (e.g. ``dt``).
    ``params`` supplies values for parent-qualified constants (the ExaHyPE2
    ``CellData`` member style, ``examples/kernel-generator.py:22-26``).
    """

    def __init__(
        self,
        kernel: KernelBuilder,
        function_name: str = "time_step",
        policy: Policy = DEFAULT_POLICY,
    ):
        super().__init__(kernel, function_name=function_name)
        self.policy = policy
        self._fn: Optional[Callable] = None

    # ----------------------------------------------------------------- build

    def build(self) -> Callable:
        if self._fn is None:
            self._fn = self._make_fn()
            self._fn.__name__ = self._function_name
        return self._fn

    def jit(self, donate_input: bool = True) -> Callable:
        """Jitted kernel; by default donates ``Q`` so XLA updates in place."""
        fn = self.build()
        donate = (0,) if donate_input else ()
        return jax.jit(fn, donate_argnums=donate)

    @property
    def jaxpr_text(self) -> str:
        """Textual jaxpr of the built kernel (the analogue of emitted MLIR)."""
        if not self.code:
            kb = self._kernel
            args = [
                jax.ShapeDtypeStruct(kb.item_shape(kb.inputs[0]), jnp.float64)
            ]
            args += [jax.ShapeDtypeStruct((), jnp.float64)] * (len(kb.inputs) - 1)
            self.code = str(jax.make_jaxpr(self.build())(*args))
        return self.code

    def _make_fn(self) -> Callable:
        kb = self._kernel
        cfg = kb.config
        if not kb.inputs:
            raise LoweringError("kernel has no primary input item")
        # Transitive range check: a demanded read outside its producer's
        # written range fails HERE (frontend/dataflow.py) instead of
        # silently consuming zero-initialized scratch.
        validate_dataflow(kb, policy=self.policy)
        primary = kb.inputs[0]
        scalar_inputs = kb.inputs[1:]
        statements = list(kb.statements)
        last_lhs = kb.LHS[-1] if kb.LHS else None

        def time_step(Q, *scalars, params: Optional[dict] = None):
            if len(scalars) != len(scalar_inputs):
                raise TypeError(
                    f"{self._function_name} expects {len(scalar_inputs)} scalar "
                    f"argument(s) {scalar_inputs}, got {len(scalars)}"
                )
            env: dict[str, Any] = {primary: jnp.asarray(Q)}
            for name, val in zip(scalar_inputs, scalars):
                env[name] = val
            env.update(kb.literal_values)
            if params:
                env.update(params)
            # Zero-initialized temporaries (deviation from the reference's
            # uninitialized `new double[...]`, documented in SURVEY.md §7).
            for name in kb.temp_items():
                if name not in env:
                    env[name] = jnp.zeros(kb.item_shape(name), dtype=Q.dtype)
            for stmt in statements:
                if stmt.kind is StatementKind.CONST_ASSIGN:
                    env[str(stmt.lhs)] = _const_value(stmt.rhs)
                else:
                    self._apply_statement(env, stmt, last_lhs)
            return env[primary]

        return time_step

    # ------------------------------------------------------------ statements

    def _apply_statement(self, env, stmt: Statement, last_lhs) -> None:
        kb = self._kernel
        cfg = kb.config
        ranges = statement_ranges(
            cfg,
            stmt,
            kb.item_struct,
            policy=self.policy,
            is_last_lhs=(last_lhs is not None and stmt.lhs == last_lhs),
        )
        spatial = ranges[1 : 1 + cfg.dim]
        vb = ranges[-1][1]

        if isinstance(stmt.lhs, AppliedUndef):
            self._apply_call_statement(env, stmt, spatial, vb)
            return
        if not isinstance(stmt.lhs, sympy.Indexed):
            raise LoweringError(f"unsupported LHS {stmt.lhs}")
        if stmt.self_referencing_stencil(cfg.spatial_index_names):
            raise LoweringError(
                f"statement '{stmt.lhs} = {stmt.rhs}' reads its own target "
                "array at a shifted index — sequential (Gauss-Seidel) "
                "semantics that vectorized evaluation cannot reproduce; "
                "write the result to a copy item instead"
            )
        _reject_pointer_call_in_var_loop(kb, stmt, vb)

        kind, value = self._eval(env, stmt.rhs, spatial, vb)
        name, slices, has_var = self._lhs_slices(stmt.lhs, spatial, vb)
        if has_var:
            if kind == _FIELD:
                value = value[..., None]
            elif kind == _SCALAR:
                value = jnp.broadcast_to(
                    jnp.asarray(value, dtype=env[name].dtype),
                    _region_shape(env[name], slices),
                )
        else:
            if kind == _VFIELD:
                if value.shape[-1] != 1:
                    raise LoweringError(
                        f"vector value written to scalar field {name}"
                    )
                value = value[..., 0]
            elif kind == _SCALAR:
                value = jnp.broadcast_to(
                    jnp.asarray(value, dtype=env[name].dtype),
                    _region_shape(env[name], slices),
                )
        env[name] = env[name].at[slices].set(value)

    def _apply_call_statement(self, env, stmt: Statement, spatial, vb) -> None:
        """Bare call with an output-pointer parameter (e.g. ``Flux``)."""
        call = stmt.lhs
        typed = self._typed(call)
        if typed.out_param is None:
            raise LoweringError(
                f"bare call to {typed.name} without out_param; nothing to store"
            )
        out_arg = call.args[typed.out_param]
        if not isinstance(out_arg, sympy.Indexed):
            raise LoweringError(f"out parameter of {typed.name} must be an array")
        in_args = [
            a for i, a in enumerate(call.args) if i != typed.out_param
        ]
        kind, value = self._eval_call(env, call.func, in_args, spatial)
        name, slices, has_var = self._lhs_slices(out_arg, spatial, vb=None)
        if has_var:
            if kind != _VFIELD:
                raise LoweringError(
                    f"{typed.name} must return a variable vector for {name}"
                )
            nvar = value.shape[-1]
            slices = slices[:-1] + (slice(0, nvar),)
        else:
            if kind == _VFIELD:
                value = value[..., 0]
        env[name] = env[name].at[slices].set(value)

    # ------------------------------------------------------------ expression

    def _eval(self, env, expr, spatial, vb):
        """Evaluate a SymPy expression over the statement region."""
        if expr is None:
            raise LoweringError("missing RHS")
        if expr.is_Number:
            return _SCALAR, float(expr)
        if isinstance(expr, sympy.Symbol):
            name = str(expr)
            if name not in env:
                raise LoweringError(
                    f"unbound symbol {name!r}; pass it via params= or register "
                    "it as a const"
                )
            return _SCALAR, env[name]
        if isinstance(expr, sympy.Indexed):
            return self._read(env, expr, spatial, vb)
        if isinstance(expr, AppliedUndef):
            return self._eval_call(env, expr.func, list(expr.args), spatial)
        if isinstance(expr, sympy.Add):
            # Fold in the same order sympy's C printer emits, so the JAX,
            # oracle, and native backends agree bitwise (summation order).
            vals = [self._eval(env, a, spatial, vb) for a in expr.as_ordered_terms()]
            return _combine(vals, lambda x, y: x + y)
        if isinstance(expr, sympy.Mul):
            vals = [self._eval(env, a, spatial, vb) for a in expr.as_ordered_factors()]
            return _combine(vals, lambda x, y: x * y)
        if isinstance(expr, sympy.Pow):
            bk, bv = self._eval(env, expr.base, spatial, vb)
            # Exact shared forms across all backends (pow() is not
            # ulp-consistent between libm/XLA): see cpp_backend._render.
            if expr.exp == sympy.Integer(-1):
                return bk, 1.0 / bv
            if expr.exp == sympy.Integer(2):
                return bk, bv * bv
            if expr.exp == sympy.Rational(1, 2):
                return bk, jnp.sqrt(bv)
            if expr.exp == sympy.Rational(-1, 2):
                return bk, 1.0 / jnp.sqrt(bv)
            ek, ev = self._eval(env, expr.exp, spatial, vb)
            if ek != _SCALAR:
                raise LoweringError("array-valued exponents are unsupported")
            return bk, bv**ev
        if isinstance(expr, (sympy.Max, sympy.Min)):
            op = jnp.maximum if isinstance(expr, sympy.Max) else jnp.minimum
            vals = [self._eval(env, a, spatial, vb) for a in expr.args]
            return _combine(vals, op)
        for cls, fn in _SYMPY_FUNCS.items():
            if isinstance(expr, cls):
                k, v = self._eval(env, expr.args[0], spatial, vb)
                return k, fn(v)
        raise LoweringError(f"cannot lower expression node {type(expr).__name__}: {expr}")

    def _eval_call(self, env, func, args, spatial):
        """Inline a typed external function, vmapped over the cell axes."""
        typed = self._typed_by_func(func)
        if typed is None or typed.jax_impl is None:
            raise LoweringError(
                f"function {func.__name__!r} has no jax_impl; supply one via "
                "kernel.function(..., jax_impl=...)"
            )
        cfg = self._kernel.config
        evaluated = []
        for a in args:
            if isinstance(a, sympy.Indexed):
                # Pointer semantics: struct items pass their full variable
                # vector at the cell; scalar fields pass the cell value.
                evaluated.append(self._read(env, a, spatial, vb=None))
            else:
                k, v = self._eval(env, a, spatial, vb=1)
                if k != _SCALAR:
                    raise LoweringError(
                        f"argument {a} of {typed.name} must be scalar or array"
                    )
                evaluated.append((_SCALAR, v))
        if typed.vectorized:
            # Batch-native impl: one fused op over the whole region.
            result = typed.jax_impl(*[v for _, v in evaluated])
        else:
            in_axes = tuple(0 if k != _SCALAR else None for k, _ in evaluated)
            mapped = typed.jax_impl
            for _ in range(cfg.dim + 1):  # patch + spatial axes
                mapped = jax.vmap(mapped, in_axes=in_axes)
            result = mapped(*[v for _, v in evaluated])
        if result.ndim == cfg.dim + 1:
            return _FIELD, result
        if result.ndim == cfg.dim + 2:
            return _VFIELD, result
        raise LoweringError(
            f"{typed.name} returned rank-{result.ndim} value; expected a "
            "per-cell scalar or vector"
        )

    # --------------------------------------------------------------- slicing

    def _read(self, env, access: sympy.Indexed, spatial, vb):
        name, slices, has_var = self._access_slices(access, spatial, vb)
        arr = env[name][slices]
        return (_VFIELD if has_var else _FIELD), arr

    def _lhs_slices(self, access: sympy.Indexed, spatial, vb):
        return self._access_slices(access, spatial, vb)

    def _access_slices(self, access: sympy.Indexed, spatial, vb):
        """Resolve an indexed access into (name, slice tuple, has_var)."""
        kb = self._kernel
        cfg = kb.config
        name = str(access.base.label)
        if name not in kb.item_struct:
            raise LoweringError(f"unknown item {name!r}")
        struct = kb.item_struct[name]
        indices = access.indices
        expected = 1 + cfg.dim + (1 if struct != 0 else 0)
        if len(indices) != expected:
            raise LoweringError(
                f"access {access} has {len(indices)} indices, expected {expected}"
            )
        slices: list[slice] = [slice(0, cfg.n_patches)]
        for level in range(1, cfg.dim + 1):
            offset = _index_offset(indices[level], str(kb.indexes[level]))
            lo, hi = spatial[level - 1]
            lo, hi = lo + offset, hi + offset
            if lo < 0 or hi > cfg.extent:
                raise LoweringError(
                    f"access {access} reads outside the halo-padded patch "
                    f"(range [{lo},{hi}) on axis {level}, extent {cfg.extent}); "
                    "increase halo_size"
                )
            slices.append(slice(lo, hi))
        has_var = struct != 0
        if has_var:
            size = cfg.n_real if struct == 1 else cfg.n_vars
            take = size if vb is None else min(vb, size)
            slices.append(slice(0, take))
        return name, tuple(slices), has_var

    # --------------------------------------------------------------- helpers

    def _typed(self, call: AppliedUndef) -> TypedFunction:
        typed = self._typed_by_func(call.func)
        if typed is None:
            raise LoweringError(f"unknown function {type(call).__name__}")
        return typed

    def _typed_by_func(self, func) -> Optional[TypedFunction]:
        return self._kernel.functions.get(func.__name__)


def _reject_pointer_call_in_var_loop(kb, stmt, vb: int) -> None:
    """Calls with struct-pointer arguments inside a var loop (vb > 1) are
    ambiguous: the C ABI passes a pointer offset by the loop's var index
    while the traced backends pass the full variable slice.  No reference
    spec exercises this; reject it instead of silently diverging."""
    if vb <= 1 or stmt.rhs is None:
        return
    for call in stmt.rhs.atoms(AppliedUndef):
        for a in call.args:
            if (
                isinstance(a, sympy.Indexed)
                and kb.item_struct.get(str(a.base.label), 0) != 0
            ):
                raise LoweringError(
                    f"call {call} passes struct pointer {a.base} inside a "
                    f"var loop of extent {vb}: the C ABI and the traced "
                    "backends would disagree; restructure the statement "
                    "(e.g. struct_override=0 or a scalar-field argument)"
                )


def _index_offset(idx_expr: sympy.Basic, expected_symbol: str) -> int:
    """Extract the integer offset from a loop-index expression like ``i+1``."""
    if isinstance(idx_expr, (sympy.Symbol, sympy.Idx)):
        if str(idx_expr) != expected_symbol:
            raise LoweringError(
                f"index {idx_expr} found where {expected_symbol} expected"
            )
        return 0
    syms = idx_expr.free_symbols
    if len(syms) != 1:
        raise LoweringError(f"unsupported index expression {idx_expr}")
    sym = next(iter(syms))
    if str(sym) != expected_symbol:
        raise LoweringError(
            f"index {idx_expr} found where {expected_symbol} expected"
        )
    offset = sympy.simplify(idx_expr - sym)
    if not offset.is_Integer:
        raise LoweringError(f"non-integer index offset in {idx_expr}")
    return int(offset)


def _const_value(expr):
    if expr is None:
        raise LoweringError("const assignment without value")
    if expr.is_Number:
        return float(expr) if not expr.is_Integer else int(expr)
    raise LoweringError(f"directional const value {expr} is not a literal")


def _region_shape(arr, slices) -> tuple[int, ...]:
    return tuple(s.stop - s.start for s in slices)


def _combine(vals, op):
    """Broadcast-combine tagged values; vfields dominate fields dominate scalars."""
    has_vfield = any(k == _VFIELD for k, _ in vals)
    has_field = any(k == _FIELD for k, _ in vals)
    norm = []
    for k, v in vals:
        if has_vfield and k == _FIELD:
            v = v[..., None]
        norm.append(v)
    out = norm[0]
    for v in norm[1:]:
        out = op(out, v)
    kind = _VFIELD if has_vfield else (_FIELD if has_field else _SCALAR)
    return kind, out
