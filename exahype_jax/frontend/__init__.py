from exahype_jax.frontend.bounds import spatial_range, statement_ranges, var_range
from exahype_jax.frontend.kernel_builder import KernelBuilder, viable
from exahype_jax.frontend.statements import Statement, StatementKind
from exahype_jax.frontend.typed_function import TypedFunction, typed_of
from exahype_jax.frontend.verify import UninitializedRead, check_initialized_reads

__all__ = [
    "KernelBuilder",
    "viable",
    "Statement",
    "StatementKind",
    "TypedFunction",
    "typed_of",
    "statement_ranges",
    "spatial_range",
    "var_range",
    "check_initialized_reads",
    "UninitializedRead",
]
