"""exahype_jax — a stencil-kernel compiler and ADER-DG solver framework for
hyperbolic PDEs, in JAX.

A ground-up rebuild of the capabilities of the ExaHyPE xDSL stencil-DSL
prototype (reference: ``xdslproject/ExaHyPE``): a SymPy-based kernel
specification API (``KernelBuilder``) describing patch-based finite-volume /
ADER-DG updates, a verifiable kernel IR with lowering passes and an opt-style
CLI, and code-generation backends.  Where the reference emits nested-loop C++
(for ExaHyPE2/Peano) and textual MLIR (via xDSL), this framework lowers the
same kernel specs to jittable JAX/XLA programs: patches batch along a sharded
leading axis on a device mesh, and halos live as array padding exchanged with
``ppermute`` collectives.  On top sit the ADER-DG solvers
(:class:`~exahype_jax.models.aderdg.ADERDGSolver`, the MOOD limiter, CK
linear kernels, tree AMR).

Public API (mirrors the reference package exports, ``exahype/__init__.py:1-2``
and ``exahype/printers/__init__.py:1``):

- :class:`~exahype_jax.frontend.kernel_builder.KernelBuilder`
- :class:`~exahype_jax.frontend.typed_function.TypedFunction`
- :class:`~exahype_jax.backends.jax_backend.JAXPrinter` (the analogue of
  the reference's ``MLIRPrinter`` — emits a jitted function, not text)
- :class:`~exahype_jax.backends.cpp_backend.CPPPrinter` (native backend for
  differential correctness testing, analogue of the reference CPPPrinter)

Every name is imported lazily: the solver path (``models.aderdg``,
``models.limiter``, ``parallel.shard``) needs neither SymPy nor the DSL.
"""

from exahype_jax.utils.errors import SemanticError

__version__ = "0.1.0"

__all__ = [
    "KernelBuilder",
    "TypedFunction",
    "KernelConfig",
    "SemanticError",
    "viable",
    "__version__",
]

_LAZY = {
    "KernelBuilder": "exahype_jax.frontend.kernel_builder",
    "viable": "exahype_jax.frontend.kernel_builder",
    "TypedFunction": "exahype_jax.frontend.typed_function",
    "KernelConfig": "exahype_jax.utils.config",
    "JAXPrinter": "exahype_jax.backends.jax_backend",
    "CPPPrinter": "exahype_jax.backends.cpp_backend",
    "MLIRPrinter": "exahype_jax.backends.mlir_backend",
    "ADERDGSolver": "exahype_jax.models.aderdg",
    "LimitedADERDG": "exahype_jax.models.limiter",
}


def __getattr__(name):
    # Lazy imports so that `import exahype_jax` stays cheap and the solver
    # path pulls in neither SymPy nor the DSL front end.
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'exahype_jax' has no attribute {name!r}")
