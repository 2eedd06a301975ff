from exahype_jax.ir.builder import FluxBuilder, IRBuilder, PatchBuilder, StencilBuilder
from exahype_jax.ir.kernel_ir import (
    CallExpr,
    DType,
    Flux,
    Kernel,
    Patch,
    Stencil,
    parse_kernel,
    print_kernel,
)
from exahype_jax.ir.loop_ir import (
    Alloc,
    ConstAssign,
    Loop,
    LoopFunction,
    Statement,
    parse_function,
    print_function,
)
from exahype_jax.ir.passes import for_to_parallel, kernel_to_loops, spec_to_loops

__all__ = [
    "Kernel",
    "Stencil",
    "Patch",
    "Flux",
    "CallExpr",
    "DType",
    "print_kernel",
    "parse_kernel",
    "LoopFunction",
    "Loop",
    "Statement",
    "Alloc",
    "ConstAssign",
    "print_function",
    "parse_function",
    "IRBuilder",
    "PatchBuilder",
    "FluxBuilder",
    "StencilBuilder",
    "spec_to_loops",
    "kernel_to_loops",
    "for_to_parallel",
]
