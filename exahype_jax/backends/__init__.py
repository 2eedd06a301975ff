from exahype_jax.backends.base import CodePrinter

__all__ = ["CodePrinter"]


def __getattr__(name):
    if name == "JAXPrinter":
        from exahype_jax.backends.jax_backend import JAXPrinter

        return JAXPrinter
    if name == "CPPPrinter":
        from exahype_jax.backends.cpp_backend import CPPPrinter

        return CPPPrinter
    if name == "run_oracle":
        from exahype_jax.backends.numpy_oracle import run_oracle

        return run_oracle
    raise AttributeError(f"module 'exahype_jax.backends' has no attribute {name!r}")
