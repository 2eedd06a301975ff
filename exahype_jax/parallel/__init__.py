__all__ = [
    "PatchGrid",
    "GridSolver",
    "make_mesh",
    "state_sharding",
    "shard_state",
    "replicated",
    "PATCH_AXIS",
    "PatchPoolRefinement",
    "DynamicPoolRefinement",
    "PoolTables",
    "PoolInner",
]

_LAZY = {
    "PatchGrid": "grid",
    "GridSolver": "solver",
    "make_mesh": "mesh",
    "state_sharding": "mesh",
    "shard_state": "mesh",
    "replicated": "mesh",
    "PATCH_AXIS": "mesh",
    "PatchPoolRefinement": "pool",
    "DynamicPoolRefinement": "pool",
    "PoolTables": "pool",
    "PoolInner": "pool",
}


def __getattr__(name):
    # Lazy: the FV grid solver and the pools need the SymPy DSL, the
    # sharded ADER-DG step (``parallel.shard``) does not.
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"exahype_jax.parallel.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'exahype_jax.parallel' has no attribute {name!r}")
