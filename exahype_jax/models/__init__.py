__all__ = [
    "euler",
    "hyperbolic",
    "build_rusanov_kernel",
    "build_fv_rusanov_kernel",
    "build_muscl_kernel",
]

_BUILDERS = {
    "build_rusanov_kernel": "rusanov",
    "build_fv_rusanov_kernel": "fv",
    "build_muscl_kernel": "muscl",
}


def __getattr__(name):
    # Everything is lazy: the kernel builders need SymPy, the solver
    # modules do not, and importing one must not pull in the other.
    import importlib

    if name in _BUILDERS:
        module = importlib.import_module(f"exahype_jax.models.{_BUILDERS[name]}")
        return getattr(module, name)
    try:
        return importlib.import_module(f"exahype_jax.models.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"exahype_jax.models.{name}":
            raise
    raise AttributeError(f"module 'exahype_jax.models' has no attribute {name!r}")
