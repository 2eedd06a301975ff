"""NumPy reference interpreter — the independent differential-test oracle.

The reference validates generated kernels by running them against an
independently hand-written C++ kernel on identical inputs and counting
element-exact differences (``Unit test/correctness_test.cpp:191-211``).
This module plays the role of that hand-written kernel for every spec the
front end can express: it executes the statement list with explicit Python
loops, element by element, with C-like pointer semantics for external
function calls (struct arguments are mutable views, out-parameters are
written in place) — deliberately the *opposite* execution model from the
vectorized JAX backend, so that agreement between the two is meaningful.

Each statement's expression tree is compiled once into a closure over the
loop-point tuple (plain Python arithmetic, no per-cell SymPy substitution);
used only in tests, but fast enough for 3-D configs.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Mapping, Optional

import numpy as np
import sympy
from sympy.core.function import AppliedUndef

from exahype_jax.frontend.bounds import DEFAULT_POLICY, Policy, statement_ranges
from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.frontend.statements import StatementKind
from exahype_jax.utils.errors import LoweringError

#: A compiled expression: (env, point) -> value, where ``point`` maps index
#: names to concrete integers.
Compiled = Callable[[dict, dict], Any]


def run_oracle(
    kernel: KernelBuilder,
    Q: np.ndarray,
    *scalars: float,
    np_impls: Optional[Mapping[str, Callable]] = None,
    params: Optional[Mapping[str, float]] = None,
    policy: Policy = DEFAULT_POLICY,
) -> np.ndarray:
    """Execute the kernel spec interpretively; returns the updated ``Q``.

    ``np_impls`` maps external-function names to NumPy implementations with
    the C-like signature convention: struct pointer parameters receive 1-D
    array views (mutable; out-parameters are written in place), scalar-field
    pointers receive their value, plain scalars pass through.
    """
    np_impls = dict(np_impls or {})
    env: dict[str, Any] = {kernel.inputs[0]: np.array(Q, copy=True)}
    for name, val in zip(kernel.inputs[1:], scalars):
        env[name] = float(val)
    env.update(kernel.literal_values)
    if params:
        env.update(params)
    for name in kernel.temp_items():
        if name not in env:
            env[name] = np.zeros(
                kernel.item_shape(name), dtype=env[kernel.inputs[0]].dtype
            )

    index_names = [str(ix) for ix in kernel.indexes]
    last_lhs = kernel.LHS[-1] if kernel.LHS else None

    for stmt in kernel.statements:
        if stmt.kind is StatementKind.CONST_ASSIGN:
            env[str(stmt.lhs)] = float(stmt.rhs)
            continue
        ranges = statement_ranges(
            kernel.config,
            stmt,
            kernel.item_struct,
            policy=policy,
            is_last_lhs=(last_lhs is not None and stmt.lhs == last_lhs),
        )
        if isinstance(stmt.lhs, AppliedUndef):
            body = _compile(stmt.lhs, kernel, np_impls)
        else:
            rhs = _compile(stmt.rhs, kernel, np_impls)
            store = _compile_store(stmt.lhs, kernel)
            body = lambda env, pt, rhs=rhs, store=store: store(env, pt, rhs(env, pt))
        loop_iters = [range(lo, hi) for lo, hi in ranges]
        for values in itertools.product(*loop_iters):
            body(env, dict(zip(index_names, values)))
    return env[kernel.inputs[0]]


def _compile_position(access: sympy.Indexed, kernel) -> Callable[[dict], tuple]:
    """Compile index expressions into (point -> element position)."""
    parts = []
    for ix in access.indices:
        if isinstance(ix, (sympy.Symbol, sympy.Idx)):
            parts.append((str(ix), 0))
        else:
            syms = list(ix.free_symbols)
            if len(syms) != 1:
                raise LoweringError(f"unsupported index expression {ix}")
            offset = sympy.simplify(ix - syms[0])
            if not offset.is_Integer:
                raise LoweringError(f"non-integer index offset in {ix}")
            parts.append((str(syms[0]), int(offset)))

    def position(pt: dict) -> tuple:
        return tuple(pt[name] + off for name, off in parts)

    return position


def _compile_store(access: sympy.Indexed, kernel) -> Callable:
    name = str(access.base.label)
    position = _compile_position(access, kernel)

    def store(env, pt, value):
        env[name][position(pt)] = value

    return store


def _compile(expr, kernel, np_impls) -> Compiled:
    if expr is None:
        raise LoweringError("missing RHS")
    if expr.is_Number:
        val = float(expr)
        return lambda env, pt: val
    if isinstance(expr, sympy.Symbol):
        name = str(expr)
        return lambda env, pt: env[name]
    if isinstance(expr, sympy.Indexed):
        name = str(expr.base.label)
        position = _compile_position(expr, kernel)
        return lambda env, pt: env[name][position(pt)]
    if isinstance(expr, AppliedUndef):
        fname = type(expr).__name__
        impl = np_impls.get(fname)
        if impl is None:
            raise LoweringError(f"no NumPy impl for function {fname!r}")
        arg_fns = []
        for a in expr.args:
            if isinstance(a, sympy.Indexed):
                name = str(a.base.label)
                struct = kernel.item_struct[name]
                position = _compile_position(a, kernel)
                if struct != 0:
                    # Pointer into the struct: 1-D view from the var position.
                    def view(env, pt, name=name, position=position):
                        pos = position(pt)
                        return env[name][pos[:-1]][pos[-1] :]

                    arg_fns.append(view)
                else:
                    arg_fns.append(
                        lambda env, pt, name=name, position=position: env[name][
                            position(pt)
                        ]
                    )
            else:
                arg_fns.append(_compile(a, kernel, np_impls))
        return lambda env, pt: impl(*[f(env, pt) for f in arg_fns])
    if isinstance(expr, sympy.Add):
        # Same fold order as the C printer (see jax_backend note).
        fns = [_compile(a, kernel, np_impls) for a in expr.as_ordered_terms()]
        def add(env, pt):
            out = fns[0](env, pt)
            for f in fns[1:]:
                out = out + f(env, pt)
            return out
        return add
    if isinstance(expr, sympy.Mul):
        fns = [_compile(a, kernel, np_impls) for a in expr.as_ordered_factors()]
        def mul(env, pt):
            out = fns[0](env, pt)
            for f in fns[1:]:
                out = out * f(env, pt)
            return out
        return mul
    if isinstance(expr, sympy.Pow):
        base = _compile(expr.base, kernel, np_impls)
        # Exact shared forms across backends (see cpp_backend._render).
        if expr.exp == sympy.Integer(-1):
            return lambda env, pt: 1.0 / base(env, pt)
        if expr.exp == sympy.Integer(2):
            return lambda env, pt: (lambda b: b * b)(base(env, pt))
        if expr.exp == sympy.Rational(1, 2):
            import math

            return lambda env, pt: math.sqrt(base(env, pt))
        if expr.exp == sympy.Rational(-1, 2):
            import math

            return lambda env, pt: 1.0 / math.sqrt(base(env, pt))
        exp = _compile(expr.exp, kernel, np_impls)
        return lambda env, pt: base(env, pt) ** exp(env, pt)
    if isinstance(expr, (sympy.Max, sympy.Min)):
        op = max if isinstance(expr, sympy.Max) else min
        fns = [_compile(a, kernel, np_impls) for a in expr.args]
        return lambda env, pt: op(f(env, pt) for f in fns)
    if isinstance(expr, sympy.Abs):
        inner = _compile(expr.args[0], kernel, np_impls)
        return lambda env, pt: abs(inner(env, pt))
    raise LoweringError(f"oracle cannot evaluate {type(expr).__name__}: {expr}")
