"""Loop IR interpreter: execute a lowered LoopFunction on NumPy arrays.

Closes the loop on path B: the reference could only *print* its dialect IR
(its lowering passes are dangling imports); here Kernel IR lowers through
``kernel_to_loops`` to Loop IR and then RUNS.  Used for golden-value tests
of the IR pipeline and for quick semantics checks from the CLI layer.

Function calls receive their arguments as element values and must return a
value (the spec pipeline's pointer-ABI calls are exercised through the
NumPy oracle instead, which knows the items' struct levels).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import sympy
from sympy.core.function import AppliedUndef

from exahype_jax.ir import loop_ir
from exahype_jax.utils.errors import LoweringError


def _compile(expr, fns: Mapping[str, Callable]):
    if expr is None:
        raise LoweringError("missing RHS")
    if expr.is_Number:
        val = float(expr)
        return lambda env, pt: val
    if isinstance(expr, (sympy.Symbol, sympy.Idx)):
        name = str(expr)
        return lambda env, pt: pt[name] if name in pt else env[name]
    if isinstance(expr, sympy.Indexed):
        name = str(expr.base.label)
        idx_fns = [_compile(ix, fns) for ix in expr.indices]
        return lambda env, pt: env[name][
            tuple(int(f(env, pt)) for f in idx_fns)
        ]
    if isinstance(expr, AppliedUndef):
        fname = type(expr).__name__
        if fname not in fns:
            raise LoweringError(f"no implementation for function {fname!r}")
        impl = fns[fname]
        arg_fns = [_compile(a, fns) for a in expr.args]
        return lambda env, pt: impl(*[f(env, pt) for f in arg_fns])
    if isinstance(expr, sympy.Add):
        terms = [_compile(a, fns) for a in expr.as_ordered_terms()]

        def add(env, pt):
            out = terms[0](env, pt)
            for f in terms[1:]:
                out = out + f(env, pt)
            return out

        return add
    if isinstance(expr, sympy.Mul):
        factors = [_compile(a, fns) for a in expr.as_ordered_factors()]

        def mul(env, pt):
            out = factors[0](env, pt)
            for f in factors[1:]:
                out = out * f(env, pt)
            return out

        return mul
    if isinstance(expr, sympy.Pow):
        base = _compile(expr.base, fns)
        exp = _compile(expr.exp, fns)
        return lambda env, pt: base(env, pt) ** exp(env, pt)
    if isinstance(expr, (sympy.Max, sympy.Min)):
        op = max if isinstance(expr, sympy.Max) else min
        args = [_compile(a, fns) for a in expr.args]
        return lambda env, pt: op(f(env, pt) for f in args)
    raise LoweringError(f"interpreter cannot evaluate {type(expr).__name__}: {expr}")


def run_loop_function(
    fn: loop_ir.LoopFunction,
    inputs: Mapping[str, np.ndarray],
    fns: Optional[Mapping[str, Callable]] = None,
    scalars: Optional[Mapping[str, float]] = None,
) -> dict[str, np.ndarray]:
    """Execute ``fn``; returns the final environment (inputs are copied)."""
    fns = dict(fns or {})
    env: dict = {k: np.array(v, dtype=np.float64, copy=True) for k, v in inputs.items()}
    env.update(scalars or {})
    for alloc in fn.allocs:
        env.setdefault(alloc.name, np.zeros(alloc.shape))

    def exec_node(node, pt):
        if isinstance(node, loop_ir.ConstAssign):
            env[node.name] = node.value
        elif isinstance(node, loop_ir.Loop):
            for value in range(node.lo, node.hi):
                pt2 = dict(pt)
                pt2[node.index] = value
                for child in node.body:
                    exec_node(child, pt2)
        elif isinstance(node, loop_ir.Statement):
            if node.rhs is None:
                _compile(node.lhs, fns)(env, pt)
            else:
                value = _compile(node.rhs, fns)(env, pt)
                name = str(node.lhs.base.label)
                pos = tuple(
                    int(_compile(ix, fns)(env, pt)) for ix in node.lhs.indices
                )
                env[name][pos] = value
        else:
            raise LoweringError(f"unknown Loop IR node {node!r}")

    for node in fn.body:
        exec_node(node, {})
    return env
