from exahype_jax.utils.config import KernelConfig
from exahype_jax.utils.errors import LoweringError, SemanticError, VerifyError
from exahype_jax.utils.list_ops import flatten

__all__ = ["KernelConfig", "SemanticError", "VerifyError", "LoweringError", "flatten"]
