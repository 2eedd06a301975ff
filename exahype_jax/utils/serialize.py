"""Ahead-of-time export of solver steps: portable serving artifacts.

The reference's deployment story is "compile the generated C++ into the
Peano production binary".  The JAX equivalent is `jax.export`:
serialize a jitted solver step to a self-contained StableHLO artifact that
any later process (or serving binary via the PJRT C API) can deserialize
and execute WITHOUT the Python frontend, the spec, or this package —
version-stable across JAX releases per the StableHLO compatibility
guarantees.

`export_step` closes over everything static (the spec lowering, operator
tensors, grid shapes); only the state array and the scalar dt remain as
call arguments.  Multi-platform artifacts (CPU + CUDA) are supported via
``platforms``.

The plain XLA steps export; the fused GPU cell stage
(:class:`~exahype_jax.models.aderdg_triton.TritonADERDG`) does not: JAX
gives its Triton custom call no serialization compatibility guarantee.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import export as jax_export


def export_step(
    step_fn: Callable,
    state_shape: tuple[int, ...],
    dtype=jnp.float32,
    platforms: Optional[Sequence[str]] = None,
):
    """Export ``step_fn(Q, dt) -> Q`` as a serialized StableHLO artifact.

    Returns the serialized artifact as ``bytes``.  ``platforms`` (e.g. ``("cpu", "cuda")``)
    builds a multi-platform artifact; default is the current backend.
    """
    fn = jax.jit(step_fn)
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exp = jax_export.export(fn, **kwargs)(
        jax.ShapeDtypeStruct(tuple(state_shape), dtype),
        jax.ShapeDtypeStruct((), dtype),
    )
    return bytes(exp.serialize())


def save_step(path, step_fn, state_shape, dtype=jnp.float32, platforms=None):
    """Export and write the artifact; returns the byte count."""
    blob = export_step(step_fn, state_shape, dtype=dtype, platforms=platforms)
    pathlib.Path(path).write_bytes(blob)
    return len(blob)


def load_step(source) -> Callable:
    """Deserialize an exported step: ``bytes`` or a path.

    Returns ``fn(Q, dt) -> Q`` executing the embedded StableHLO — no spec,
    solver object, or frontend required.
    """
    blob = (
        bytes(source)
        if isinstance(source, (bytes, bytearray))
        else pathlib.Path(source).read_bytes()
    )
    exp = jax_export.deserialize(blob)

    def fn(Q, dt):
        return exp.call(Q, dt)

    return fn
