"""Error types for the exahype_jax compiler.

The reference routes user-facing specification errors through a single
``SemanticError`` exception (``exahype/util/semantic_error.py:1-2``,
caught by the CLI at ``exahype/tools/exahype-opt:111-113``).  We keep that
channel and add a verifier error for IR-level invariant violations.
"""


class SemanticError(Exception):
    """A kernel specification is semantically invalid (user error)."""


class VerifyError(Exception):
    """An IR invariant was violated (compiler-internal or hand-built IR error)."""


class LoweringError(Exception):
    """A kernel spec could not be lowered to the requested backend."""
