"""Typed external functions for kernel specs.

The reference wraps ``sympy.Function`` instances and monkey-patches accessor
methods carrying a return type and parameter types so the MLIR backend can
emit typed external declarations (``exahype/TypedFunction.py:15-34``, used at
``exahype/SymPyToMLIR.py:1043-1061``).

Here the same user-facing contract is kept (``kernel.function(...)`` returns a
callable usable inside SymPy expressions) but the type metadata lives in a
proper registry keyed by function name, and — the difference from the
reference — a function may carry a **JAX implementation**: a traceable
callable that the JAX backend inlines into the generated kernel (the reference instead
calls opaque C++ symbols through pointers, ``Unit test/Functions.h:1-3``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import sympy
from sympy.codegen.ast import none


class TypedFunction:
    """Factory for a typed, optionally JAX-backed sympy function.

    Instances behave like ``sympy.Function('name')``: calling them builds a
    SymPy applied-function node.  Type metadata is available both on the
    factory and (for reference API parity) via ``returnType()`` /
    ``parameterTypes()`` accessors on the produced function class.
    """

    def __init__(
        self,
        name: str,
        parameter_types: Sequence[Any] = (),
        return_type: Any = none,
        jax_impl: Callable | None = None,
        out_param: int | None = None,
        vectorized: bool = False,
    ):
        self.name = name
        self.parameter_types = list(parameter_types)
        self.return_type = return_type
        #: Traceable JAX callable implementing the function body, or None if
        #: the function is only available to the native (C++) backend.
        self.jax_impl = jax_impl
        #: Index of an output-pointer parameter, if the function writes its
        #: result through an argument instead of returning it (the reference's
        #: ``Flux(Q, normal, F)`` convention, ``Unit test/Functions.cpp:9-37``).
        self.out_param = out_param
        #: If True, ``jax_impl`` natively handles batched cell axes: struct
        #: pointer parameters arrive as ``[patch, *spatial, var]`` arrays,
        #: scalar-field pointers as ``[patch, *spatial]``, and it returns an
        #: array with the same leading axes.  This is the fast path — one
        #: fused op over the whole region instead of a per-cell vmap nest
        #: (hugely smaller HLO, better fusion).  If False, the impl is
        #: per-cell (vectors/scalars) and the backend vmaps it.
        self.vectorized = vectorized

        fn = sympy.Function(name)
        # Reference-compatible accessors (``exahype/TypedFunction.py:26-34``):
        # with no argument they read, with an argument they set.
        typed = self

        def returnType(arg=None):
            if arg is not None:
                typed.return_type = arg
            return typed.return_type

        def parameterTypes(arg=None):
            if arg is not None:
                typed.parameter_types = list(arg)
            return typed.parameter_types

        fn.returnType = staticmethod(returnType)
        fn.parameterTypes = staticmethod(parameterTypes)
        fn._typed = typed
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return f"TypedFunction({self.name!r})"


def typed_of(expr: sympy.Basic) -> TypedFunction | None:
    """Return the TypedFunction registry entry for an applied function node."""
    return getattr(expr.func, "_typed", None)
